/* hxi_sfun.h -- compact SimStruct emulation for hosting compiled
 * S-function-style models in the hqp_tpu framework.
 *
 * The PyTorch port's own copy of the JAX package's native/hxi/hxi_sfun.h
 * (same struct layout, same accessors).
 *
 * Role of the reference's hxi/Hxi_SimStruct.h + hxi/simstruc.h (an
 * in-process re-implementation of a subset of Simulink's level-2
 * S-function API, hxi/README:17-38): model C code is written against the
 * familiar mdlInitializeSizes / mdlDerivatives / mdlOutputs / mdlUpdate
 * callbacks and the ss* accessors below, compiled to a shared library,
 * and loaded by the Python host (hqp_tpu_torch/hxi/sfunction.py) through a
 * fixed, ctypes-friendly C ABI.
 *
 * Unlike the reference we do not template real_T over an AD type
 * (hxi/README:30-38): derivatives of hosted models are obtained by the
 * host via finite differences or a model-provided mdlJacobian, exactly
 * like the reference's default FD path (hqp/Hqp_Docp.C:1098).
 *
 * The struct layout is the ABI: the Python loader mirrors it with
 * ctypes.Structure, so fields may only be appended, never reordered.
 */
#ifndef HXI_SFUN_H
#define HXI_SFUN_H

#include <stdlib.h>
#include <string.h>

#define HXI_MAX_PARAMS 16
#define HXI_ERRMSG_LEN 256

typedef double real_T;
typedef int int_T;

typedef struct HxiSimStruct {
    /* sizes (set by mdlInitializeSizes) */
    int_T nx;         /* continuous states */
    int_T nxd;        /* discrete states */
    int_T nu;         /* inputs (single port) */
    int_T ny;         /* outputs (single port) */
    int_T np;         /* expected S-function parameters */
    int_T np_set;     /* parameters actually provided by host */
    /* capacities allocated by the host */
    int_T cap;        /* capacity of each data array below */
    /* time */
    real_T t;
    real_T sample_time;  /* discrete sample time hint (0 = continuous) */
    /* data (host-allocated, length >= cap each) */
    real_T *x;        /* continuous states */
    real_T *dx;       /* derivatives (mdlDerivatives output) */
    real_T *xd;       /* discrete states (updated in place by mdlUpdate) */
    real_T *u;        /* inputs */
    real_T *y;        /* outputs (mdlOutputs output) */
    /* parameters: np_set arrays of doubles */
    real_T *p[HXI_MAX_PARAMS];
    int_T p_len[HXI_MAX_PARAMS];
    /* error reporting (ssSetErrorStatus) */
    char errmsg[HXI_ERRMSG_LEN];
} SimStruct;

/* ---- Simulink-style accessors (subset used by hosted models) ---------- */
#define ssSetNumSFcnParams(S, n)   ((S)->np = (n))
#define ssGetNumSFcnParams(S)      ((S)->np)
#define ssGetSFcnParamsCount(S)    ((S)->np_set)
#define ssGetSFcnParam(S, i)       ((S)->p[i])
#define ssGetSFcnParamLen(S, i)    ((S)->p_len[i])

#define ssSetNumContStates(S, n)   ((S)->nx = (n))
#define ssGetNumContStates(S)      ((S)->nx)
#define ssGetContStates(S)         ((S)->x)
#define ssGetdX(S)                 ((S)->dx)

#define ssSetNumDiscStates(S, n)   ((S)->nxd = (n))
#define ssGetNumDiscStates(S)      ((S)->nxd)
#define ssGetDiscStates(S)         ((S)->xd)
#define ssGetRealDiscStates(S)     ((S)->xd)

#define ssSetNumInputs(S, n)       ((S)->nu = (n))
#define ssGetNumInputs(S)          ((S)->nu)
#define ssGetInputSignal(S)        ((S)->u)

#define ssSetNumOutputs(S, n)      ((S)->ny = (n))
#define ssGetNumOutputs(S)         ((S)->ny)
#define ssGetOutputSignal(S)       ((S)->y)

#define ssGetT(S)                  ((S)->t)
#define ssSetSampleTime(S, ts)     ((S)->sample_time = (ts))
#define ssGetSampleTime(S)         ((S)->sample_time)

#define ssSetErrorStatus(S, msg) \
    do { strncpy((S)->errmsg, (msg), HXI_ERRMSG_LEN - 1); } while (0)

/* mxArray-lite helpers for parameter access */
#define mxGetPr(param)             (param)

#endif /* HXI_SFUN_H */

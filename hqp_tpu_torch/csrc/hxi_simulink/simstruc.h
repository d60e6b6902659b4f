/*
 * simstruc.h -- Simulink level-2 S-function SimStruct emulation.
 *
 * Role of the reference's hxi/Hxi_SimStruct.h (see hxi/README:17-38):
 * enough of the MathWorks simstruc API that unmodified level-2 C
 * S-function sources (e.g. the reference's odc/sfun_did.c,
 * odc/sfun_dic.c -- classic dsfunc.c/csfunc.c-derived models) compile
 * and run against this header with no MATLAB installation.  The
 * companion cg_sfun.h (included by the S-function source in its
 * non-MEX branch) exports the mdl* entry points plus host accessors
 * for the ctypes loader (hqp_tpu_torch/hxi/simulink.py).
 *
 * This is a fresh implementation against the public simstruc API
 * surface used by such sources; it shares no code with MathWorks
 * headers or with the reference's templated C++ emulation.
 */
#ifndef HXI_SIMSTRUC_H
#define HXI_SIMSTRUC_H

#include <stdlib.h>
#include <string.h>

/* ---- basic types (tmwtypes role) ---------------------------------------- */
typedef double real_T;
typedef float real32_T;
typedef int int_T;
typedef unsigned int uint_T;
typedef unsigned char boolean_T;
typedef char char_T;

#ifndef NULL
#define NULL ((void *)0)
#endif
#ifndef UNUSED_ARG
#define UNUSED_ARG(x) (void)(x)
#endif

/* ---- minimal mxArray (real dense matrices only) ------------------------- */
typedef struct hxi_mxArray_tag {
    real_T *pr;
    int_T m, n;
    int_T is_numeric;   /* 1 for the arrays the host passes in */
} mxArray;

static int_T mxIsEmpty(const mxArray *a)   { return a == NULL || a->m * a->n == 0; }
static int_T mxIsSparse(const mxArray *a)  { UNUSED_ARG(a); return 0; }
static int_T mxIsComplex(const mxArray *a) { UNUSED_ARG(a); return 0; }
static int_T mxIsNumeric(const mxArray *a) { return a != NULL && a->is_numeric; }
static int_T mxGetNumberOfElements(const mxArray *a) { return a ? a->m * a->n : 0; }
static int_T mxGetM(const mxArray *a) { return a ? a->m : 0; }
static int_T mxGetN(const mxArray *a) { return a ? a->n : 0; }
static real_T *mxGetPr(const mxArray *a) { return a ? a->pr : NULL; }
static int_T mxIsChar(const mxArray *a) { return a != NULL && !a->is_numeric; }
static int_T mxGetString(const mxArray *a, char *buf, int_T buflen)
{
    int_T i, len = a ? a->m * a->n : 0;
    if (len > buflen - 1) len = buflen - 1;
    for (i = 0; i < len; i++) buf[i] = (char)a->pr[i];
    buf[len] = '\0';
    return 0;
}

/* ---- capacities --------------------------------------------------------- */
#define HXI_MAX_PORTS        8
#define HXI_MAX_PARAMS       32
#define HXI_MAX_SAMPLE_TIMES 8

/* ---- SimStruct ---------------------------------------------------------- */
typedef struct SimStruct_tag {
    /* parameters */
    int_T  nparams_expected;
    int_T  nparams;
    mxArray params[HXI_MAX_PARAMS];
    const char *error_status;

    /* sizes */
    int_T  ncont, ndisc;
    int_T  nin, nout;
    int_T  in_width[HXI_MAX_PORTS];
    int_T  out_width[HXI_MAX_PORTS];
    int_T  in_feedthrough[HXI_MAX_PORTS];
    int_T  nsample;
    real_T sample_time[HXI_MAX_SAMPLE_TIMES];
    real_T offset_time[HXI_MAX_SAMPLE_TIMES];
    int_T  nrwork, niwork, npwork, nmodes, nzc;
    int_T  jac_nnz;
    uint_T options;

    /* runtime buffers (allocated by hxi_ss_allocate after sizes are set) */
    real_T  t;
    real_T *xc;       /* continuous states */
    real_T *dx;       /* their derivatives */
    real_T *xd;       /* discrete states */
    real_T *in_buf[HXI_MAX_PORTS];
    const real_T **in_ptrs[HXI_MAX_PORTS];
    real_T *out_buf[HXI_MAX_PORTS];
    real_T *rwork;
    int_T  *iwork;
    void  **pwork;
    real_T *jac_pr;
    int_T  *jac_ir;
    int_T  *jac_jc;
    int_T   jac_ncols;

    /* ---- MEX method table (Hxi_MEX_SFunction role) ----------------------
     * A MEX-built S-function exports ONLY mexFunction; our simulink.c
     * twin registers the static mdl* methods here during the flag-0
     * initialization call so the host (mex_host.c) can drive them
     * through function pointers -- the same design as the reference's
     * ssSetmdlOutputs/... registration (hxi/Hxi_MEX_SFunction.C:355+,
     * hxi/Hxi_SimStruct.h method slots). */
    struct {
        void (*initializeSizes)(struct SimStruct_tag *);
        void (*initializeSampleTimes)(struct SimStruct_tag *);
        void (*initializeConditions)(struct SimStruct_tag *);
        void (*start)(struct SimStruct_tag *);
        void (*outputs)(struct SimStruct_tag *, int_T);
        void (*update)(struct SimStruct_tag *, int_T);
        void (*derivatives)(struct SimStruct_tag *);
        void (*jacobian)(struct SimStruct_tag *);
        void (*terminate)(struct SimStruct_tag *);
    } methods;
} SimStruct;

/* MEX pointer-smuggling protocol (see simulink.c / mex_host.c): the
 * SimStruct pointer rides bit-exactly in element 0 of a double vector,
 * the S-function level in element 1 (the reference packs int_T words +
 * SIMSTRUCT_VERSION_LEVEL2, Hxi_MEX_SFunction.C:281-289; one 64-bit
 * double carries the whole pointer on every platform we target). */
#define HXI_SIMSTRUCT_VERSION_LEVEL2 2.0

typedef const real_T *const *InputRealPtrsType;

/* ---- options flags (values are private to this emulation) -------------- */
#define SS_OPTION_EXCEPTION_FREE_CODE            0x0001u
#define SS_OPTION_DISCRETE_VALUED_OUTPUT         0x0002u
#define SS_OPTION_PLACE_ASAP                     0x0004u
#define SS_OPTION_USE_TLC_WITH_ACCELERATOR       0x0008u
#define SS_OPTION_CALL_TERMINATE_ON_EXIT         0x0010u
#define SS_OPTION_RUNTIME_EXCEPTION_FREE_CODE    0x0020u

#define CONTINUOUS_SAMPLE_TIME 0.0
#define INHERITED_SAMPLE_TIME  (-1.0)
#define FIXED_IN_MINOR_STEP_OFFSET 1.0

/* ---- ss accessor macros ------------------------------------------------- */
#define ssSetNumSFcnParams(S, n)   ((S)->nparams_expected = (n))
#define ssGetNumSFcnParams(S)      ((S)->nparams_expected)
#define ssGetSFcnParamsCount(S)    ((S)->nparams)
#define ssGetSFcnParam(S, i)       (&(S)->params[i])
#define ssSetErrorStatus(S, msg)   ((S)->error_status = (msg))
#define ssGetErrorStatus(S)        ((S)->error_status)

#define ssSetNumContStates(S, n)   ((S)->ncont = (n))
#define ssGetNumContStates(S)      ((S)->ncont)
#define ssSetNumDiscStates(S, n)   ((S)->ndisc = (n))
#define ssGetNumDiscStates(S)      ((S)->ndisc)

#define ssSetNumInputPorts(S, n)   (((S)->nin = (n)), 1)
#define ssGetNumInputPorts(S)      ((S)->nin)
#define ssSetInputPortWidth(S, p, w)  ((S)->in_width[p] = (w))
#define ssGetInputPortWidth(S, p)     ((S)->in_width[p])
#define ssSetInputPortDirectFeedThrough(S, p, v) ((S)->in_feedthrough[p] = (v))
#define ssGetInputPortDirectFeedThrough(S, p)    ((S)->in_feedthrough[p])

#define ssSetNumOutputPorts(S, n)  (((S)->nout = (n)), 1)
#define ssGetNumOutputPorts(S)     ((S)->nout)
#define ssSetOutputPortWidth(S, p, w) ((S)->out_width[p] = (w))
#define ssGetOutputPortWidth(S, p)    ((S)->out_width[p])

#define ssSetNumSampleTimes(S, n)  ((S)->nsample = (n))
#define ssGetNumSampleTimes(S)     ((S)->nsample)
#define ssSetSampleTime(S, i, v)   ((S)->sample_time[i] = (v))
#define ssGetSampleTime(S, i)      ((S)->sample_time[i])
#define ssSetOffsetTime(S, i, v)   ((S)->offset_time[i] = (v))
#define ssGetOffsetTime(S, i)      ((S)->offset_time[i])

#define ssSetNumRWork(S, n)        ((S)->nrwork = (n))
#define ssGetNumRWork(S)           ((S)->nrwork)
#define ssSetNumIWork(S, n)        ((S)->niwork = (n))
#define ssGetNumIWork(S)           ((S)->niwork)
#define ssSetNumPWork(S, n)        ((S)->npwork = (n))
#define ssGetNumPWork(S)           ((S)->npwork)
#define ssSetNumModes(S, n)        ((S)->nmodes = (n))
#define ssSetNumNonsampledZCs(S, n) ((S)->nzc = (n))
#define ssSetOptions(S, o)         ((S)->options = (o))
#define ssGetOptions(S)            ((S)->options)

#define ssGetT(S)                  ((S)->t)
#define ssSetT(S, v)               ((S)->t = (v))
#define ssIsSampleHit(S, i, tid)   (1)
#define ssIsMajorTimeStep(S)       (1)
#define ssIsMinorTimeStep(S)       (0)

#define ssGetContStates(S)         ((S)->xc)
#define ssGetdX(S)                 ((S)->dx)
#define ssGetDiscStates(S)         ((S)->xd)
#define ssGetRealDiscStates(S)     ((S)->xd)

#define ssGetInputPortRealSignalPtrs(S, p) \
    ((InputRealPtrsType)(S)->in_ptrs[p])
#define ssGetInputPortRealSignal(S, p)   ((const real_T *)(S)->in_buf[p])
#define ssGetOutputPortRealSignal(S, p)  ((S)->out_buf[p])

#define ssGetRWork(S)              ((S)->rwork)
#define ssGetIWork(S)              ((S)->iwork)
#define ssGetPWork(S)              ((S)->pwork)

#define ssSetJacobianNzMax(S, n)   ((S)->jac_nnz = (n))
#define ssGetJacobianNzMax(S)      ((S)->jac_nnz)
#define ssGetJacobianPr(S)         ((S)->jac_pr)
#define ssGetJacobianIr(S)         ((S)->jac_ir)
#define ssGetJacobianJc(S)         ((S)->jac_jc)

/* some sources warn through this; make it a no-op */
#define ssWarning(S, msg)          UNUSED_ARG(S)
#define ssPrintf(...)              ((void)0)

#endif /* HXI_SIMSTRUC_H */

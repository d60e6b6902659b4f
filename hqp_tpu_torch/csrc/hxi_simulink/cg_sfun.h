/*
 * cg_sfun.h -- host-side registration for SimStruct-emulated S-functions.
 *
 * A level-2 C S-function source ends with
 *
 *     #ifdef MATLAB_MEX_FILE
 *     #include "simulink.c"
 *     #else
 *     #include "cg_sfun.h"
 *     #endif
 *
 * so this header is textually included AFTER the static mdl* methods and
 * can export them (the same mechanism the reference uses to build
 * S-functions against its emulation, hxi/Hxi_SimStruct.h; odc/Makefile).
 * It additionally exports allocation/accessor entry points consumed by
 * the ctypes loader hqp_tpu_torch/hxi/simulink.py.
 */
#ifndef HXI_CG_SFUN_H
#define HXI_CG_SFUN_H

#include <stdlib.h>
#include <string.h>

#define HXI_EXPORT __attribute__((visibility("default")))

/* ---- lifecycle ---------------------------------------------------------- */

HXI_EXPORT SimStruct *hxi_ss_create(void)
{
    SimStruct *S = (SimStruct *)calloc(1, sizeof(SimStruct));
    return S;
}

HXI_EXPORT void hxi_ss_set_param(SimStruct *S, int_T i, real_T *data,
                                 int_T m, int_T n)
{
    if (i >= HXI_MAX_PARAMS) return;
    if (i >= S->nparams) S->nparams = i + 1;
    S->params[i].pr = data;
    S->params[i].m = m;
    S->params[i].n = n;
    S->params[i].is_numeric = 1;
}

/* character-array parameter (char codes in doubles; mxIsChar /
 * mxGetString read it back -- Hxi_mx_parse string-argument role) */
HXI_EXPORT void hxi_ss_set_param_char(SimStruct *S, int_T i, real_T *data,
                                      int_T m, int_T n)
{
    hxi_ss_set_param(S, i, data, m, n);
    S->params[i].is_numeric = 0;
}

/* allocate runtime buffers once mdlInitializeSizes has run */
HXI_EXPORT void hxi_ss_allocate(SimStruct *S)
{
    int_T p, i, ncols, nrows_all;
    S->xc = (real_T *)calloc(S->ncont > 0 ? S->ncont : 1, sizeof(real_T));
    S->dx = (real_T *)calloc(S->ncont > 0 ? S->ncont : 1, sizeof(real_T));
    S->xd = (real_T *)calloc(S->ndisc > 0 ? S->ndisc : 1, sizeof(real_T));
    for (p = 0; p < S->nin; p++) {
        int_T w = S->in_width[p] > 0 ? S->in_width[p] : 1;
        S->in_buf[p] = (real_T *)calloc(w, sizeof(real_T));
        S->in_ptrs[p] = (const real_T **)calloc(w, sizeof(real_T *));
        for (i = 0; i < w; i++)
            S->in_ptrs[p][i] = &S->in_buf[p][i];
    }
    for (p = 0; p < S->nout; p++) {
        int_T w = S->out_width[p] > 0 ? S->out_width[p] : 1;
        S->out_buf[p] = (real_T *)calloc(w, sizeof(real_T));
    }
    S->rwork = (real_T *)calloc(S->nrwork > 0 ? S->nrwork : 1,
                                sizeof(real_T));
    S->iwork = (int_T *)calloc(S->niwork > 0 ? S->niwork : 1,
                               sizeof(int_T));
    S->pwork = (void **)calloc(S->npwork > 0 ? S->npwork : 1,
                               sizeof(void *));
    /* Jacobian J = d(dxc, xd, y)/d(xc, xd, u), compressed columns */
    ncols = S->ncont + S->ndisc;
    for (p = 0; p < S->nin; p++) ncols += S->in_width[p];
    nrows_all = S->ncont + S->ndisc;
    for (p = 0; p < S->nout; p++) nrows_all += S->out_width[p];
    (void)nrows_all;
    S->jac_ncols = ncols;
    if (S->jac_nnz > 0) {
        S->jac_pr = (real_T *)calloc(S->jac_nnz, sizeof(real_T));
        S->jac_ir = (int_T *)calloc(S->jac_nnz, sizeof(int_T));
        S->jac_jc = (int_T *)calloc(ncols + 1, sizeof(int_T));
    }
}

HXI_EXPORT void hxi_ss_destroy(SimStruct *S)
{
    int_T p;
    if (!S) return;
    free(S->xc); free(S->dx); free(S->xd);
    for (p = 0; p < S->nin; p++) {
        free(S->in_buf[p]);
        free((void *)S->in_ptrs[p]);
    }
    for (p = 0; p < S->nout; p++) free(S->out_buf[p]);
    free(S->rwork); free(S->iwork); free(S->pwork);
    free(S->jac_pr); free(S->jac_ir); free(S->jac_jc);
    free(S);
}

/* ---- accessors for the ctypes host -------------------------------------- */

HXI_EXPORT int_T hxi_ss_ncont(SimStruct *S) { return S->ncont; }
HXI_EXPORT int_T hxi_ss_ndisc(SimStruct *S) { return S->ndisc; }
HXI_EXPORT int_T hxi_ss_nin(SimStruct *S) { return S->nin; }
HXI_EXPORT int_T hxi_ss_nout(SimStruct *S) { return S->nout; }
HXI_EXPORT int_T hxi_ss_in_width(SimStruct *S, int_T p)
{ return S->in_width[p]; }
HXI_EXPORT int_T hxi_ss_out_width(SimStruct *S, int_T p)
{ return S->out_width[p]; }
HXI_EXPORT real_T hxi_ss_sample_time(SimStruct *S, int_T i)
{ return S->sample_time[i]; }
HXI_EXPORT const char *hxi_ss_error(SimStruct *S)
{ return S->error_status; }
HXI_EXPORT real_T *hxi_ss_xc(SimStruct *S) { return S->xc; }
HXI_EXPORT real_T *hxi_ss_dx(SimStruct *S) { return S->dx; }
HXI_EXPORT real_T *hxi_ss_xd(SimStruct *S) { return S->xd; }
HXI_EXPORT real_T *hxi_ss_u(SimStruct *S, int_T p) { return S->in_buf[p]; }
HXI_EXPORT real_T *hxi_ss_y(SimStruct *S, int_T p) { return S->out_buf[p]; }
HXI_EXPORT void hxi_ss_set_t(SimStruct *S, real_T t) { S->t = t; }
HXI_EXPORT int_T hxi_ss_jac_nnz(SimStruct *S) { return S->jac_nnz; }
HXI_EXPORT int_T hxi_ss_jac_ncols(SimStruct *S) { return S->jac_ncols; }
HXI_EXPORT real_T *hxi_ss_jac_pr(SimStruct *S) { return S->jac_pr; }
HXI_EXPORT int_T *hxi_ss_jac_ir(SimStruct *S) { return S->jac_ir; }
HXI_EXPORT int_T *hxi_ss_jac_jc(SimStruct *S) { return S->jac_jc; }

/* ---- mdl entry points ---------------------------------------------------
 * mdlInitializeSizes/SampleTimes/Outputs/Terminate are mandatory in a
 * level-2 S-function; the optional ones are guarded by the MDL_* defines
 * the source sets before including this header. */

HXI_EXPORT void hxi_mdlInitializeSizes(SimStruct *S)
{ mdlInitializeSizes(S); }

HXI_EXPORT void hxi_mdlInitializeSampleTimes(SimStruct *S)
{ mdlInitializeSampleTimes(S); }

HXI_EXPORT void hxi_mdlInitializeConditions(SimStruct *S)
{
#if defined(MDL_INITIALIZE_CONDITIONS)
    mdlInitializeConditions(S);
#else
    UNUSED_ARG(S);
#endif
}

HXI_EXPORT void hxi_mdlStart(SimStruct *S)
{
#if defined(MDL_START)
    mdlStart(S);
#else
    UNUSED_ARG(S);
#endif
}

HXI_EXPORT void hxi_mdlOutputs(SimStruct *S, int_T tid)
{ mdlOutputs(S, tid); }

HXI_EXPORT void hxi_mdlUpdate(SimStruct *S, int_T tid)
{
#if defined(MDL_UPDATE)
    mdlUpdate(S, tid);
#else
    UNUSED_ARG(S); UNUSED_ARG(tid);
#endif
}

HXI_EXPORT void hxi_mdlDerivatives(SimStruct *S)
{
#if defined(MDL_DERIVATIVES)
    mdlDerivatives(S);
#else
    UNUSED_ARG(S);
#endif
}

HXI_EXPORT void hxi_mdlJacobian(SimStruct *S)
{
#if defined(MDL_JACOBIAN)
    mdlJacobian(S);
#else
    UNUSED_ARG(S);
#endif
}

HXI_EXPORT void hxi_mdlTerminate(SimStruct *S)
{ mdlTerminate(S); }

/* capability flags so the host knows which optional methods exist */
HXI_EXPORT int_T hxi_has_update(void)
{
#if defined(MDL_UPDATE)
    return 1;
#else
    return 0;
#endif
}

HXI_EXPORT int_T hxi_has_derivatives(void)
{
#if defined(MDL_DERIVATIVES)
    return 1;
#else
    return 0;
#endif
}

HXI_EXPORT int_T hxi_has_jacobian(void)
{
#if defined(MDL_JACOBIAN)
    return 1;
#else
    return 0;
#endif
}

#endif /* HXI_CG_SFUN_H */

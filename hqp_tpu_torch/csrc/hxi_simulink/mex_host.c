/*
 * mex_host.c -- host-side support library for MEX-built S-functions.
 *
 * Role of the reference's hxi/Hxi_MEX_SFunction.C: allocate the
 * SimStruct, initialize the MEX S-function through its single exported
 * entry point `mexFunction` (SimStruct pointer smuggled through a
 * double vector + level tag + flag 0 -- Hxi_MEX_SFunction.C:270-300),
 * then drive the method pointers the gateway registered (simulink.c).
 *
 * Build once into libhximexhost.so (hqp_tpu_torch/hxi/mex.py); the generic
 * SimStruct accessors come from cg_sfun.h (the dummy static mdl*
 * definitions below only satisfy its unused wrapper exports -- a MEX
 * S-function is driven exclusively through the method table).
 */
#include "simstruc.h"

static void mdlInitializeSizes(SimStruct *S) { UNUSED_ARG(S); }
static void mdlInitializeSampleTimes(SimStruct *S) { UNUSED_ARG(S); }
static void mdlOutputs(SimStruct *S, int_T tid)
{ UNUSED_ARG(S); UNUSED_ARG(tid); }
static void mdlTerminate(SimStruct *S) { UNUSED_ARG(S); }

#include "cg_sfun.h"

typedef void (*hxi_mexFunction_t)(int, mxArray **, int, mxArray **);

/* Initialize a MEX S-function: one gateway call with the reference's
 * argument protocol.  Returns 0 on success, nonzero on error (the
 * error string is readable via hxi_ss_error). */
HXI_EXPORT int_T hxi_mex_init(SimStruct *S, void *mexfn)
{
    mxArray *prhs[4] = {NULL, NULL, NULL, NULL};
    mxArray *plhs[1] = {NULL};
    mxArray xarg, flagarg;
    real_T xbuf[2], flagbuf[1];

    memcpy(&xbuf[0], &S, sizeof(S));
    xbuf[1] = HXI_SIMSTRUCT_VERSION_LEVEL2;
    xarg.pr = xbuf; xarg.m = 2; xarg.n = 1; xarg.is_numeric = 1;
    flagbuf[0] = 0.0;
    flagarg.pr = flagbuf; flagarg.m = 1; flagarg.n = 1;
    flagarg.is_numeric = 1;
    prhs[1] = &xarg;
    prhs[3] = &flagarg;

    ((hxi_mexFunction_t)mexfn)(1, plhs, 4, prhs);

    if (S->error_status != NULL)
        return 1;
    if (S->methods.initializeSizes == NULL) {
        S->error_status = "mexFunction registered no S-function methods";
        return 2;
    }
    if (S->nparams_expected != S->nparams) {
        S->error_status = "S-function parameter count mismatch";
        return 3;
    }
    return 0;
}

/* ---- method-table drivers ------------------------------------------- */

HXI_EXPORT void hxi_mex_initializeSampleTimes(SimStruct *S)
{ if (S->methods.initializeSampleTimes) S->methods.initializeSampleTimes(S); }

HXI_EXPORT void hxi_mex_initializeConditions(SimStruct *S)
{ if (S->methods.initializeConditions) S->methods.initializeConditions(S); }

HXI_EXPORT void hxi_mex_start(SimStruct *S)
{ if (S->methods.start) S->methods.start(S); }

HXI_EXPORT void hxi_mex_outputs(SimStruct *S, int_T tid)
{ if (S->methods.outputs) S->methods.outputs(S, tid); }

HXI_EXPORT void hxi_mex_update(SimStruct *S, int_T tid)
{ if (S->methods.update) S->methods.update(S, tid); }

HXI_EXPORT void hxi_mex_derivatives(SimStruct *S)
{ if (S->methods.derivatives) S->methods.derivatives(S); }

HXI_EXPORT void hxi_mex_jacobian(SimStruct *S)
{ if (S->methods.jacobian) S->methods.jacobian(S); }

HXI_EXPORT void hxi_mex_terminate(SimStruct *S)
{ if (S->methods.terminate) S->methods.terminate(S); }

HXI_EXPORT int_T hxi_mex_has_update(SimStruct *S)
{ return S->methods.update != NULL; }

HXI_EXPORT int_T hxi_mex_has_derivatives(SimStruct *S)
{ return S->methods.derivatives != NULL; }

HXI_EXPORT int_T hxi_mex_has_jacobian(SimStruct *S)
{ return S->methods.jacobian != NULL; }

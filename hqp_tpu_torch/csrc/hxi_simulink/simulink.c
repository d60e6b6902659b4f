/*
 * simulink.c -- MEX-file interface twin for SimStruct-emulated
 * S-functions.
 *
 * A level-2 C S-function source compiled with -DMATLAB_MEX_FILE ends
 * with `#include "simulink.c"`; with MathWorks tooling that include
 * generates the mexFunction gateway.  This twin generates the gateway
 * against our emulation (simstruc.h): the host (mex_host.c, the role of
 * the reference's hxi/Hxi_MEX_SFunction.C) calls
 *
 *     mexFunction(1, plhs, 4, prhs)
 *
 * with the SimStruct pointer smuggled bit-exactly into prhs[1] (element
 * 0; element 1 = S-function level) and the method selector flag in
 * prhs[3] -- the reference's own calling protocol
 * (Hxi_MEX_SFunction.C:270-300: Hxi_RHS_X carries the pointer words +
 * SIMSTRUCT_VERSION_LEVEL2, Hxi_RHS_FLAG carries 0 for initialization).
 * For flag 0 the gateway registers this compilation unit's static mdl*
 * methods in the SimStruct method table and runs mdlInitializeSizes;
 * all later driving happens through the registered pointers.
 *
 * The optional-method guards mirror the standard S-function template
 * macros (MDL_START, MDL_INITIALIZE_CONDITIONS, MDL_UPDATE,
 * MDL_DERIVATIVES, MDL_JACOBIAN).
 */
#ifndef HXI_SIMULINK_C
#define HXI_SIMULINK_C

#include <string.h>

#ifndef HXI_MEX_EXPORT
#define HXI_MEX_EXPORT __attribute__((visibility("default")))
#endif

HXI_MEX_EXPORT void
mexFunction(int nlhs, mxArray *plhs[], int nrhs, mxArray *prhs[])
{
    SimStruct *S;
    double flag;

    (void)nlhs; (void)plhs;
    if (nrhs < 4 || prhs[1] == NULL || prhs[3] == NULL
        || mxGetNumberOfElements(prhs[1]) < 2
        || mxGetPr(prhs[1])[mxGetNumberOfElements(prhs[1]) - 1]
           != HXI_SIMSTRUCT_VERSION_LEVEL2)
        return;

    memcpy(&S, mxGetPr(prhs[1]), sizeof(S));
    flag = mxGetPr(prhs[3])[0];
    if (flag != 0.0) {
        if (S) ssSetErrorStatus(S, "unsupported MEX flag");
        return;
    }

    S->methods.initializeSizes = mdlInitializeSizes;
    S->methods.initializeSampleTimes = mdlInitializeSampleTimes;
    S->methods.terminate = mdlTerminate;
    S->methods.outputs = mdlOutputs;
#if defined(MDL_INITIALIZE_CONDITIONS)
    S->methods.initializeConditions = mdlInitializeConditions;
#endif
#if defined(MDL_START)
    S->methods.start = mdlStart;
#endif
#if defined(MDL_UPDATE)
    S->methods.update = mdlUpdate;
#endif
#if defined(MDL_DERIVATIVES)
    S->methods.derivatives = mdlDerivatives;
#endif
#if defined(MDL_JACOBIAN)
    S->methods.jacobian = mdlJacobian;
#endif

    mdlInitializeSizes(S);
}

#endif /* HXI_SIMULINK_C */

/*
 * sfun_did_demo.c -- discrete-time double integrator as a standard
 * level-2 C S-function (in-tree demo for the MEX hosting path).
 *
 * Exact-discretization dynamics matching hqp_tpu_torch.models.did.PrgDID.f:
 *     x0' = x0 + u dt
 *     x1' = x0 dt + x1 + u dt^2/2
 * One parameter: dt.  Written from scratch for this repository (the
 * reference ships its own odc/sfun_did.c exercising the same model;
 * tests compare both paths).
 */
#define S_FUNCTION_NAME  sfun_did_demo
#define S_FUNCTION_LEVEL 2

#include "simstruc.h"

#define P_DT(S) (mxGetPr(ssGetSFcnParam(S, 0))[0])

static void mdlInitializeSizes(SimStruct *S)
{
    ssSetNumSFcnParams(S, 1);
    if (ssGetNumSFcnParams(S) != ssGetSFcnParamsCount(S))
        return;
    ssSetNumContStates(S, 0);
    ssSetNumDiscStates(S, 2);
    ssSetNumInputPorts(S, 1);
    ssSetInputPortWidth(S, 0, 1);
    ssSetInputPortDirectFeedThrough(S, 0, 0);
    ssSetNumOutputPorts(S, 1);
    ssSetOutputPortWidth(S, 0, 2);
    ssSetNumSampleTimes(S, 1);
}

static void mdlInitializeSampleTimes(SimStruct *S)
{
    ssSetSampleTime(S, 0, P_DT(S));
    ssSetOffsetTime(S, 0, 0.0);
}

#define MDL_INITIALIZE_CONDITIONS
static void mdlInitializeConditions(SimStruct *S)
{
    real_T *xd = ssGetRealDiscStates(S);
    xd[0] = 1.0;
    xd[1] = 0.0;
}

static void mdlOutputs(SimStruct *S, int_T tid)
{
    real_T *y = ssGetOutputPortRealSignal(S, 0);
    real_T *xd = ssGetRealDiscStates(S);
    UNUSED_ARG(tid);
    y[0] = xd[0];
    y[1] = xd[1];
}

#define MDL_UPDATE
static void mdlUpdate(SimStruct *S, int_T tid)
{
    real_T *xd = ssGetRealDiscStates(S);
    InputRealPtrsType uPtrs = ssGetInputPortRealSignalPtrs(S, 0);
    real_T dt = P_DT(S);
    real_T u = *uPtrs[0];
    real_T v = xd[0];
    UNUSED_ARG(tid);
    xd[0] = v + u * dt;
    xd[1] = v * dt + xd[1] + u * 0.5 * dt * dt;
}

static void mdlTerminate(SimStruct *S)
{
    UNUSED_ARG(S);
}

#ifdef MATLAB_MEX_FILE
#include "simulink.c"
#else
#include "cg_sfun.h"
#endif

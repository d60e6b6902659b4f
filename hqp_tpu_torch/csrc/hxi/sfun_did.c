/* sfun_did.c -- discrete-time double-integrator S-function demo.
 *
 * Role of the reference's odc/sfun_did.c (discrete double integrator used
 * by the DID_SFunction example): two discrete states (velocity v,
 * position s -- the state order of hqp_docp/Prg_DID.C), one input
 * (acceleration u), exact zero-order-hold discretization with sample
 * time dt (parameter):
 *     v+ = v + dt u
 *     s+ = s + dt v + dt^2/2 u
 * Outputs = states.
 */
#define S_FUNCTION_NAME sfun_did
#include "hxi_sfun.h"

static void mdlInitializeSizes(SimStruct *S)
{
    ssSetNumSFcnParams(S, 1);      /* dt */
    if (ssGetSFcnParamsCount(S) != 1) {
        ssSetErrorStatus(S, "sfun_did expects 1 parameter (dt)");
        return;
    }
    ssSetNumContStates(S, 0);
    ssSetNumDiscStates(S, 2);
    ssSetNumInputs(S, 1);
    ssSetNumOutputs(S, 2);
    ssSetSampleTime(S, -1.0);      /* inherit dt from parameter */
}

static void mdlOutputs(SimStruct *S, int_T tid)
{
    const real_T *xd = ssGetRealDiscStates(S);
    real_T *y = ssGetOutputSignal(S);
    (void)tid;
    y[0] = xd[0];
    y[1] = xd[1];
}

#define HXI_HAS_UPDATE
static void mdlUpdate(SimStruct *S, int_T tid)
{
    real_T *xd = ssGetRealDiscStates(S);
    const real_T *u = ssGetInputSignal(S);
    real_T dt = mxGetPr(ssGetSFcnParam(S, 0))[0];
    real_T v = xd[0], s = xd[1];
    (void)tid;
    xd[0] = v + dt * u[0];
    xd[1] = s + dt * v + 0.5 * dt * dt * u[0];
}

#include "hxi_sfun_exports.h"

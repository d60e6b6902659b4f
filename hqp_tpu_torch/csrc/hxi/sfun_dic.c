/* sfun_dic.c -- continuous-time double-integrator S-function demo.
 *
 * Role of the reference's odc/sfun_dic.c (continuous double integrator
 * used by the DIC_SFunction example): two continuous states (velocity v,
 * position s -- the state order of hqp_docp/Prg_DID.C), one input
 * (force u), outputs = states.  One parameter: the mass m (dv/dt = u/m),
 * so the parameter path is exercised.
 */
#define S_FUNCTION_NAME sfun_dic
#include "hxi_sfun.h"

static void mdlInitializeSizes(SimStruct *S)
{
    ssSetNumSFcnParams(S, 1);      /* m */
    if (ssGetSFcnParamsCount(S) != 1) {
        ssSetErrorStatus(S, "sfun_dic expects 1 parameter (mass)");
        return;
    }
    ssSetNumContStates(S, 2);
    ssSetNumDiscStates(S, 0);
    ssSetNumInputs(S, 1);
    ssSetNumOutputs(S, 2);
    ssSetSampleTime(S, 0.0);       /* continuous */
}

#define HXI_HAS_DERIVATIVES
static void mdlDerivatives(SimStruct *S)
{
    const real_T *x = ssGetContStates(S);
    const real_T *u = ssGetInputSignal(S);
    real_T *dx = ssGetdX(S);
    real_T m = mxGetPr(ssGetSFcnParam(S, 0))[0];
    dx[0] = u[0] / m;   /* dv */
    dx[1] = x[0];       /* ds = v */
}

static void mdlOutputs(SimStruct *S, int_T tid)
{
    const real_T *x = ssGetContStates(S);
    real_T *y = ssGetOutputSignal(S);
    (void)tid;
    y[0] = x[0];
    y[1] = x[1];
}

#include "hxi_sfun_exports.h"

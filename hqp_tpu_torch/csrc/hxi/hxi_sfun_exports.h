/* hxi_sfun_exports.h -- include at the END of an S-function .c file,
 * after defining S_FUNCTION_NAME and the static mdl* callbacks, to
 * export the fixed-name C ABI consumed by hqp_tpu_torch/hxi/sfunction.py
 * (the port's own copy of native/hxi/hxi_sfun_exports.h).
 *
 * Role of the reference's method-dispatch wrappers in
 * hxi/Hxi_SFunction.{h,C} (which dlopens a compiled S-function and calls
 * mdlInitializeSizes/mdlDerivatives/mdlOutputs/mdlUpdate through looked-up
 * symbols, Hxi_SFunction.h:28-45).  The host:
 *   1. allocates a SimStruct and data buffers,
 *   2. calls hxi_mdlInitializeSizes to learn sizes,
 *   3. fills parameters, calls hxi_mdlStart (optional init of states),
 *   4. per evaluation sets t/x/u and calls derivatives/outputs/update.
 * All exported calls return 0 on success, -1 if the model set an error.
 */
#ifndef HXI_SFUN_EXPORTS_H
#define HXI_SFUN_EXPORTS_H

#ifndef S_FUNCTION_NAME
#error "define S_FUNCTION_NAME before including hxi_sfun_exports.h"
#endif

#define HXI_CHECK(S) ((S)->errmsg[0] ? -1 : 0)

#ifdef __cplusplus
extern "C" {
#endif

int hxi_mdlInitializeSizes(SimStruct *S) {
    S->errmsg[0] = 0;
    mdlInitializeSizes(S);
    return HXI_CHECK(S);
}

int hxi_mdlInitializeSampleTimes(SimStruct *S) {
    S->errmsg[0] = 0;
#ifdef HXI_HAS_SAMPLE_TIMES
    mdlInitializeSampleTimes(S);
#endif
    return HXI_CHECK(S);
}

int hxi_mdlStart(SimStruct *S) {
    S->errmsg[0] = 0;
#ifdef HXI_HAS_START
    mdlStart(S);
#endif
    return HXI_CHECK(S);
}

int hxi_mdlInitializeConditions(SimStruct *S) {
    S->errmsg[0] = 0;
#ifdef HXI_HAS_INITIALIZE_CONDITIONS
    mdlInitializeConditions(S);
#endif
    return HXI_CHECK(S);
}

int hxi_mdlDerivatives(SimStruct *S) {
    S->errmsg[0] = 0;
#ifdef HXI_HAS_DERIVATIVES
    mdlDerivatives(S);
#endif
    return HXI_CHECK(S);
}

int hxi_mdlOutputs(SimStruct *S) {
    S->errmsg[0] = 0;
    mdlOutputs(S, 0);
    return HXI_CHECK(S);
}

int hxi_mdlUpdate(SimStruct *S) {
    S->errmsg[0] = 0;
#ifdef HXI_HAS_UPDATE
    mdlUpdate(S, 0);
#endif
    return HXI_CHECK(S);
}

int hxi_mdlTerminate(SimStruct *S) {
    S->errmsg[0] = 0;
#ifdef HXI_HAS_TERMINATE
    mdlTerminate(S);
#endif
    return HXI_CHECK(S);
}

#ifdef __cplusplus
}
#endif

#endif /* HXI_SFUN_EXPORTS_H */

"""hxi -- hosting of external (non-torch) models.

Port of ``hqp_tpu/hxi`` (reference: hxi/Hxi_SimStruct.{h,C},
hxi/Hxi_SFunction.{h,C}, hxi/sfun_fmu.c + hxi/fmi.tcl): models supplied as
compiled S-function-style shared libraries or as FMI 2.0 model-exchange
FMUs are loaded in-process and presented to the optimizer through the
same :class:`hqp_tpu_torch.omu.model.Model` protocol as models written in
torch ops (:class:`hqp_tpu_torch.omu.hosted.HostedModel`).  Host
evaluation crosses the device boundary as one counted copy a batch of
stages each way; Jacobians come from the model
(fmi2GetDirectionalDerivative) when available, else from central finite
differences -- the reference's default (hqp/Hqp_Docp.C:1098
update_grds).  Level-2 Simulink S-function sources compile unmodified
against the port's SimStruct emulation (:mod:`hqp_tpu_torch.hxi.simulink`,
the cg_sfun build; :mod:`hqp_tpu_torch.hxi.mex`, the MEX build whose only
export is ``mexFunction``), with MATLAB-style parameter text parsed by
:mod:`hqp_tpu_torch.hxi.mx_parse`.
"""

from hqp_tpu_torch.hxi.simstruct import PySimStruct  # noqa: F401
from hqp_tpu_torch.hxi.sfunction import SFunction, compile_sfunction  # noqa: F401
from hqp_tpu_torch.hxi.fmu import Fmu  # noqa: F401
from hqp_tpu_torch.hxi.mx_parse import parse_args  # noqa: F401
from hqp_tpu_torch.hxi.simulink import (  # noqa: F401
    SimulinkSFunction, build_sfunction)
from hqp_tpu_torch.hxi.mex import (  # noqa: F401
    MexEvaluator, MexSFunction, build_mex_sfunction)

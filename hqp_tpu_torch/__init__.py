"""hqp_tpu_torch -- the PyTorch/CUDA port of hqp_tpu.

The module layout and names follow ``hqp_tpu`` one to one, so each piece
has an obvious counterpart in the JAX reference package:

  ops/       small-block linear algebra (``smalllin``, ``blocktri``) and the
             hand-written CUDA kernels with their plain twins: ``gj_cuda``
             (batched pivoted Gauss-Jordan interior inverse; a register
             kernel for tiles that fit a block, a global-memory kernel up
             to s = 512) and ``thomas_cuda`` (batched block-Thomas master
             solve); ``_build`` compiles ``csrc/*.cu`` with nvcc at first
             CUDA use, ``_build_host`` the host library
             ``csrc/host/sparse_ldl.cpp`` with g++ at first use
  native     ctypes binding of that host library: ``rcm_order``,
             ``SparseLDL``, ``SparseBKP``
  qp/        ``StageQP`` and ``DenseQP`` IRs (a StageQP may carry leading
             batch axes), the KKT backends (``PartitionedKKT``, which
             also takes a batch; the oracles ``RiccatiKKT``,
             ``FullStageKKT``; ``DenseKKT`` for the general path and the
             host-sparse ``SparseCallbackKKT``, ``SparseHostKKT`` and
             ``FullSparseBKPKKT``, registered as RedSpBKP, RedSpBKP_host
             and SpBKP), the
             ``Mehrotra`` and ``Franke`` interior points, and
             ``presolve`` (``merge_parallel_rows``,
             ``original_row_violation``)
  sqp/       ``SqpSolver``, ``SqpPowell``, ``SqpSchittkowski`` and the
             Hessian strategies (``BFGS``, ``DScale``, ``Gerschgorin``,
             ``AugBFGS``, ``Gangster``, ``SparseBFGS``)
  docp/      stage-wise ``Docp`` programs and general ``Nlp`` programs,
             with ``torch.func`` derivatives
  omu/       the Omuses front end: ``OmuProgram`` (continuous-time
             multistage programs), every integrator of the reference,
             fixed-step and adaptive (registered under
             ``prg_integrator``);
             the user's ``Model`` (torch ops) and ``HostedModel`` (an
             S-function or FMU evaluated on the host, one counted copy
             of a batch of stages each way); the formulations
             ``DynamicOpt``, ``DynamicEst``, ``DTOpt`` and ``DTEst``
             (registered under ``prg_name``, with the aliases
             SFunctionOpt and SFunctionEst); ``plt_io`` (OmSim .plt files)
  hxi/       hosting of external models: the Python SimStruct
             (``PySimStruct``, ``PySFunctionHost``), compiled S-functions
             (``SFunction``; ``compile_sfunction`` builds a .c source
             against ``csrc/hxi/`` with cc into ``build/``), FMI 2.0
             FMUs (``Fmu``, ``build_test_fmu``), and level-2 Simulink
             S-functions compiled against the SimStruct emulation of
             ``csrc/hxi_simulink/`` (``simulink``: the cg_sfun build,
             ``SimulinkSFunction``; ``mex``: the MEX build driven through
             ``mexFunction``, ``MexSFunction``, ``MexEvaluator``; the
             parameter text parser ``mx_parse``)
  models/    ``PrgDID``, ``PrgCrane`` and the odc suite (``omu_suite``:
             ``PrgBatchReactor``, ``PrgBio``, ``PrgTP383omu``,
             ``PrgHS99omu``, ``PrgCranePar``), registered under
             ``prg_name`` as DID, Crane, BatchReactor, Bio, TP383omu,
             HS99omu and CranePar; the hosted suite (``hxi_suite``:
             DID_SFunction, DID_MEX, DIC, DIC_SFunction, DIC_FMU); the
             NLP suite (``nlp_suite``:
             TP383, Maratos, HS99) and the generated families
             (``nlp_gen``: LQBlend, Broydn3d, Bdqrtic, Catena, SRosenbr,
             and ``solve_generated``); the SIF reader (``sif``:
             ``PrgSIF``, registered as SIF and CUTE, and ``solve_sif``)
  parallel/  ``scenarios``: whole QP solves over a leading scenario axis
             (``batched_qp``, ``make_scenario_init``,
             ``make_scenario_step``, ``make_scenario_solve``; BASELINE
             config 5), one host loop over the batch, and the batch's
             split over the ranks of a mesh (``make_mesh``,
             ``shard_batch``, ``gather_batch``); ``distributed``:
             ``torch.distributed`` groups and device meshes
             (``init_distributed``, ``global_mesh``,
             ``process_summary``); ``sharded_kkt``:
             ``ShardedPartitionedKKT`` (qp_mat_solver SpSCdist), the
             partitions split over the ranks
  utils/     registry, masked reductions over dataclasses of tensors
             (per problem of a batch too), counted host reads, the
             least-squares multiplier start
  convert    numpy -> port data (tests feed both packages the same data)

Differences in idiom, not in algorithm: dataclasses of tensors replace
pytrees (``utils.masked.tmap`` maps them field-wise), every tensor carries
an explicit ``device`` and ``dtype=torch.float64`` (there is no global x64
switch), and the device-side ``lax`` loops of the reference run as host
Python loops that read one scalar per test.
"""

import torch as _torch

# TF32 off: the f32 factor path (PartitionedKKT(factor_dtype="f32")) uses
# f32 products inside refinement loops, whose contraction needs true f32
# rounding; TF32 keeps ~10 mantissa bits and would make the refinement
# diverge (the counterpart of hqp_tpu/__init__.py's "highest" matmul
# precision).  f64 work is unaffected.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from hqp_tpu_torch.utils.registry import modules  # noqa: E402
from hqp_tpu_torch.qp.program import DenseQP, StageQP  # noqa: E402
from hqp_tpu_torch.qp.mehrotra import Mehrotra  # noqa: E402
from hqp_tpu_torch.sqp.solver import SqpSolver, solve  # noqa: E402
from hqp_tpu_torch.docp.program import Docp  # noqa: E402
from hqp_tpu_torch.qp.kkt_sparse_host import (  # noqa: E402
    FullSparseBKPKKT, SparseCallbackKKT, SparseHostKKT)
from hqp_tpu_torch.models.sif import PrgSIF, solve_sif  # noqa: E402
from hqp_tpu_torch.omu.model import Model  # noqa: E402
from hqp_tpu_torch.omu.hosted import HostedModel  # noqa: E402
from hqp_tpu_torch.omu.dynamic_opt import DynamicOpt  # noqa: E402
from hqp_tpu_torch.omu.dynamic_est import DynamicEst  # noqa: E402
from hqp_tpu_torch.omu.dt_opt import DTEst, DTOpt  # noqa: E402
import hqp_tpu_torch.models.hxi_suite  # noqa: E402,F401  (registers it)

__all__ = ["modules", "StageQP", "DenseQP", "Mehrotra", "SqpSolver",
           "solve", "Docp", "SparseCallbackKKT", "SparseHostKKT",
           "FullSparseBKPKKT", "PrgSIF", "solve_sif", "Model",
           "HostedModel", "DynamicOpt", "DynamicEst", "DTOpt", "DTEst"]

"""Import every module that self-registers components.

Port of ``hqp_tpu/all_modules.py``: the reference wires its registries at
library init (hqp/Hqp_Init.C:96-121 Hqp_ClassAlloc, omu/Omu_Init.C
Omu_ClassAlloc); importing this module is the equivalent: afterwards,
every solver / KKT backend / Hessian / integrator / program is reachable
by name through :data:`hqp_tpu_torch.utils.registry.modules`.
"""

# flake8: noqa: F401
import hqp_tpu_torch.models.did
import hqp_tpu_torch.models.crane
import hqp_tpu_torch.models.nlp_suite
import hqp_tpu_torch.models.omu_suite
import hqp_tpu_torch.models.hxi_suite
import hqp_tpu_torch.omu.integrators
import hqp_tpu_torch.omu.dynamic_opt
import hqp_tpu_torch.omu.dynamic_est
import hqp_tpu_torch.omu.dt_opt
import hqp_tpu_torch.sqp.powell
import hqp_tpu_torch.sqp.schittkowski
import hqp_tpu_torch.sqp.hessian
import hqp_tpu_torch.qp.mehrotra
import hqp_tpu_torch.qp.franke
import hqp_tpu_torch.qp.kkt
import hqp_tpu_torch.qp.kkt_partitioned
import hqp_tpu_torch.qp.kkt_sparse_host
import hqp_tpu_torch.mip.branch_bound
import hqp_tpu_torch.qp.client
import hqp_tpu_torch.parallel.sharded_kkt

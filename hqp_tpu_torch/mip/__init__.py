"""Mixed-integer layer (Hqp_MipSolver / Hqp_LPSolve role)."""

from hqp_tpu_torch.mip.branch_bound import BranchBound  # noqa: F401

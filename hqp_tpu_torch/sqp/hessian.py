"""Hessian approximations for the SQP Lagrangian ("hela").

Port of ``hqp_tpu/sqp/hessian.py`` (the base ``HL`` and the block BFGS;
the other strategies wait).  Reference: hqp/Hqp_HL.{h,C},
Hqp_HL_BFGS.C.  The Hessian is a batch of dense diagonal blocks
``[B, nb, nb]`` (for a DOCP B = K+1 stages, nb = nx+nu), and every block
update runs batched over B.
"""

from __future__ import annotations

import torch

from hqp_tpu_torch.utils.registry import modules


def _eye_like(Qb):
    return torch.eye(Qb.shape[-1], dtype=Qb.dtype, device=Qb.device)


def gerschgorin_posdef(Qb: torch.Tensor, eps: float) -> torch.Tensor:
    """diag_i = max(diag_i, sum_j|offdiag_ij| + eps); Hqp_HL.C:256-311."""
    d = torch.diagonal(Qb, dim1=-2, dim2=-1)
    rowsum = Qb.abs().sum(dim=-1) - d.abs()
    newd = torch.maximum(d, rowsum + eps)
    return Qb + torch.diag_embed(newd - d)


class HL:
    """Base Hessian strategy (Hqp_HL).  Subclasses implement update()."""

    def __init__(self, scale: int = 1, eps: float = 1e-8):
        self.scale = scale
        self.eps = eps

    def init(self, prg, x, y, z, Qb):
        """Initial block Hessian (Hqp_HL::init, Hqp_HL.C:84-171).

        A nonzero program Q only gets its definiteness repaired; otherwise
        a (scaled) identity.  scale == 0: identity; 1: per-component
        dgL_i/dx_i; 2: 0.5*||dgL||/||dx||; >= 3: |dgL'dx| / dx'dx, with dgL
        the Lagrangian-gradient change under dx_i = |1e-4 x_i| + 1e-6."""
        nonzero = Qb.abs().amax() > self.eps
        eye = _eye_like(Qb)
        if self.scale <= 0:
            Qinit = eye.expand_as(Qb)
        else:
            gL = prg.eval_grd_L(x, y, z)
            dx = (1e-4 * x).abs() + 1e-6
            dgL = prg.eval_grd_L(x + dx, y, z) - gL
            if self.scale == 1:
                val = torch.clamp(dgL / dx, min=self.eps)
            elif self.scale == 2:
                nrm = torch.sqrt((dgL * dgL).sum() / (dx * dx).sum())
                val = torch.clamp(0.5 * nrm, min=self.eps) * torch.ones_like(x)
            else:
                r = ((dgL * dx).sum() / (dx * dx).sum()).abs()
                val = torch.clamp(r, min=self.eps) * torch.ones_like(x)
            Qinit = torch.diag_embed(prg.split_blocks(val))
        return torch.where(nonzero, gerschgorin_posdef(Qb, self.eps), Qinit)

    def update(self, Qb, s_b, u_b, alpha):
        raise NotImplementedError


@modules.register("sqp_hela", "BFGS")
class BFGS(HL):
    """Block-diagonal damped BFGS (Hqp_HL_BFGS.C)."""

    def __init__(self, gamma: float = 0.1, eigen_control: bool = True,
                 **kw):
        super().__init__(**kw)
        self.gamma = gamma
        self.eigen_control = eigen_control

    def update(self, Qb, s_b, u_b, alpha):
        """Damped BFGS per block, batched over the blocks
        (Hqp_HL_BFGS.C:150-222, update_b_Q).

        Qb: [B, nb, nb]; s_b, u_b: [B, nb]; alpha: step length taken."""
        eps = self.eps
        if self.gamma >= 0.0:
            g = self.gamma
        else:
            g = -self.gamma
            g = g + (1.0 - g) * (1.0 - alpha)

        s, u = s_b, u_b
        sv = (s * u).sum(-1)                               # [B]
        Qs = (Qb @ s[..., None])[..., 0]                   # [B, nb]
        sQs = (s * Qs).sum(-1)

        # Powell's modification (damping)
        theta = (1.0 - g) * sQs / torch.where(sQs - sv != 0.0, sQs - sv, 1.0)
        damped = sv < g * sQs
        v = torch.where(damped[:, None],
                        theta[:, None] * u + (1.0 - theta[:, None]) * Qs, u)
        sv2 = torch.where(damped, (s * v).sum(-1), sv)

        ok = (sv2 != 0.0) & (sQs != 0.0)
        denom_sQs = torch.where(sQs != 0.0, sQs, 1.0)
        denom_sv = torch.where(sv2 != 0.0, sv2, 1.0)
        Qn = Qb - Qs[:, :, None] * Qs[:, None, :] / denom_sQs[:, None, None] \
            + v[:, :, None] * v[:, None, :] / denom_sv[:, None, None]
        Qn = torch.where(ok[:, None, None], Qn, Qb)

        if self.eigen_control:
            # eigenvalue control (Hqp_HL_BFGS.C:203-221)
            th = torch.where((sQs < eps * eps) & (sQs >= 0.0), sQs, eps * eps)
            evs = torch.linalg.eigvalsh(0.5 * (Qn + Qn.transpose(-1, -2)))
            mn = evs.amin(-1) - th
            Qn = torch.where((mn < 0.0)[:, None, None],
                             Qn - mn[:, None, None] * _eye_like(Qb), Qn)
        return 0.5 * (Qn + Qn.transpose(-1, -2))

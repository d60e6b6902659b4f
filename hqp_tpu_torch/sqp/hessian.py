"""Hessian approximations for the SQP Lagrangian ("hela").

Port of ``hqp_tpu/sqp/hessian.py`` (reference: hqp/Hqp_HL.{h,C},
Hqp_HL_BFGS.C, Hqp_HL_DScale.C, Hqp_HL_Gerschgorin.C, Hqp_HL_AugBFGS.C,
Hqp_HL_Gangster.C): the base ``HL`` with its scale modes and least-squares
multiplier start, the damped block BFGS, the diagonal ``DScale``, the
exact-Hessian ``Gerschgorin``, ``AugBFGS``, ``Gangster`` and the
partitioned ``SparseBFGS`` (Hqp_HL_SparseBFGS.C).  The Hessian is a batch
of dense diagonal blocks ``[B, nb, nb]`` (for a DOCP B = K+1 stages,
nb = nx+nu; for an NLP one block), and every block update runs batched
over B.
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

    def __init__(self, scale: int = 1, eps: float = 1e-8,
                 init_multipliers: bool = False):
        self.scale = scale
        self.eps = eps
        #: start the SQP from least-squares equality multipliers
        #: (Hqp_HL::est_y) instead of zero
        self.init_multipliers = init_multipliers

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

    def posdef(self, Qb):
        return gerschgorin_posdef(Qb, self.eps)


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


@modules.register("sqp_hela", "DScale")
class DScale(HL):
    """Diagonal-only scaling update (Hqp_HL_DScale.C): a diagonal Hessian
    whose entries track u_i/s_i with safeguards."""

    def update(self, Qb, s_b, u_b, alpha):
        d = torch.diagonal(Qb, dim1=-2, dim2=-1)
        ok = (s_b.abs() > 1e-16) & (u_b * s_b > 0.0)
        newd = torch.where(ok, u_b / torch.where(ok, s_b, 1.0), d)
        return torch.diag_embed(torch.clamp(newd, self.eps, 1.0 / self.eps))


@modules.register("sqp_hela", "Gerschgorin")
class Gerschgorin(HL):
    """Exact Lagrangian Hessian with per-iteration Gerschgorin
    regularization (Hqp_HL_Gerschgorin.C).  The SQP binds the current
    iterate before each update; a program with ``eval_hess_blocks``
    supplies the exact blocks, any other gets its blocks repaired."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._prg = None
        self._xyz = None

    def bind(self, prg, x, y, z):
        self._prg = prg
        self._xyz = (x, y, z)

    def update(self, Qb, s_b, u_b, alpha):
        if self._prg is None or not hasattr(self._prg, "eval_hess_blocks"):
            return gerschgorin_posdef(Qb, self.eps)
        return gerschgorin_posdef(self._prg.eval_hess_blocks(*self._xyz),
                                  self.eps)


@modules.register("sqp_hela", "SparseBFGS")
class SparseBFGS(BFGS):
    """Partitioned BFGS over sparsity-discovered diagonal blocks
    (Hqp_HL_SparseBFGS.C): RCM-permute the Hessian's sparsity pattern
    (:70-113, sp_symrcm), split the permuted pattern into its connected
    contiguous diagonal blocks (next_block, :255-276) and run the damped
    BFGS update on each block alone (:216-247); entries outside the blocks
    keep their values.

    Stage layouts ``[B, nb, nb]`` arrive partitioned already and take the
    batched BFGS.  For an NLP's one block the partition is discovered once
    on the host: from the program's exact Lagrangian Hessian at the first
    :meth:`bind`, else from the numeric pattern of the first Q updated."""

    def __init__(self, pattern_eps: float = 0.0, **kw):
        super().__init__(**kw)
        #: entries with |Q_ij| <= pattern_eps count as structural zeros
        self.pattern_eps = pattern_eps
        self._perm = None
        self._inv = None
        self._blocks = None

    def bind(self, prg, x, y, z):
        """Discover the partition from the exact Lagrangian Hessian of a
        program that has one (the reference reads the pattern of the
        program's sparse Q, Hqp_HL_SparseBFGS.C:75-78)."""
        if self._perm is None and hasattr(prg, "eval_hess_blocks"):
            Hb = prg.eval_hess_blocks(x, y, z)
            if Hb.shape[0] == 1:
                self._discover(Hb[0])

    def _discover(self, Q):
        """RCM order and contiguous-block scan of Q's symmetric pattern."""
        import numpy as np
        import scipy.sparse as sp

        from hqp_tpu_torch.native import rcm_order
        from hqp_tpu_torch.utils.sync import to_host

        n = Q.shape[0]
        A = np.abs(to_host(Q)) > self.pattern_eps
        A = A | A.T
        np.fill_diagonal(A, True)
        pat = sp.csr_matrix(A.astype(np.float64))
        pat.sort_indices()
        perm = np.asarray(rcm_order(n, pat.indptr, pat.indices))
        P = pat[perm][:, perm].tocsr()
        P.sort_indices()
        blocks = []
        b = 0
        while b < n:
            offs = end = b
            while b <= end:
                row = P.indices[P.indptr[b]:P.indptr[b + 1]]
                if len(row):
                    end = max(end, int(row.max()))
                b += 1
            blocks.append((offs, end - offs + 1))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        dev = Q.device
        self._perm = torch.as_tensor(perm, dtype=torch.int64, device=dev)
        self._inv = torch.as_tensor(inv, dtype=torch.int64, device=dev)
        self._blocks = blocks

    def update(self, Qb, s_b, u_b, alpha):
        if Qb.shape[0] != 1:
            return super().update(Qb, s_b, u_b, alpha)
        Q = Qb[0]
        if self._perm is None or len(self._perm) != Q.shape[0]:
            self._discover(Q)
        perm, inv = self._perm, self._inv
        Qp = Q[perm][:, perm]
        sp_, up_ = s_b[0][perm], u_b[0][perm]
        out = Qp.clone()
        for offs, size in self._blocks:
            sl = slice(offs, offs + size)
            out[sl, sl] = super().update(Qp[sl, sl][None], sp_[sl][None],
                                         up_[sl][None], alpha)[0]
        return out[inv][:, inv][None]


@modules.register("sqp_hela", "AugBFGS")
class AugBFGS(BFGS):
    """BFGS with per-block inertia correction (Hqp_HL_AugBFGS.C role):
    after the damped update each block is shifted so that its smallest
    eigenvalue is at least ``inertia_eps`` times its largest."""

    def __init__(self, inertia_eps: float = 1e-6, **kw):
        kw.setdefault("eigen_control", False)
        super().__init__(**kw)
        self.inertia_eps = inertia_eps

    def update(self, Qb, s_b, u_b, alpha):
        Qn = super().update(Qb, s_b, u_b, alpha)
        evs = torch.linalg.eigvalsh(0.5 * (Qn + Qn.transpose(-1, -2)))
        lo = evs[..., 0]
        hi = torch.clamp(evs[..., -1], min=self.eps)
        shift = torch.clamp(self.inertia_eps * hi - lo, min=0.0)
        return Qn + shift[..., None, None] * _eye_like(Qn)


@modules.register("sqp_hela", "Gangster")
class Gangster(BFGS):
    """BFGS update projected onto the sparsity pattern of the initial
    Hessian blocks (the 'gangster operator', Hqp_HL_Gangster.C): entries
    outside it are zeroed after every update, then the blocks repaired."""

    def __init__(self, **kw):
        kw.setdefault("eigen_control", False)
        super().__init__(**kw)
        self._pattern = None

    def init(self, prg, x, y, z, Qb):
        Q0 = super().init(prg, x, y, z, Qb)
        self._pattern = (Q0.abs() > 0.0) | _eye_like(Q0).to(torch.bool)
        return Q0

    def update(self, Qb, s_b, u_b, alpha):
        Qn = super().update(Qb, s_b, u_b, alpha)
        if self._pattern is not None:
            Qn = gerschgorin_posdef(torch.where(self._pattern, Qn, 0.0),
                                    self.eps)
        return Qn

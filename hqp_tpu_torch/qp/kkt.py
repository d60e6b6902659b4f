"""Shared KKT reduction helpers and the oracle backends.

Port of ``hqp_tpu/qp/kkt.py``: the backend-generic helpers, the
sequential Riccati oracle (:class:`RiccatiKKT`, ``qp_mat_solver
Riccati``), the dense LU backend of the general path (:class:`DenseKKT`,
``qp_mat_solver DenseKKT``) and the dense lowering of a StageQP
(:class:`FullStageKKT`, ``qp_mat_solver FullKKT``).  Every backend solves
the per-iteration KKT system (hqp/Hqp_IpMatrix.h:42-89)

    | -Q  A'  C'  0 | |dx|   |r1|
    |  A  0   0   0 | |dy|   |r2|
    |  C  0   0  -I | |dz| = |r3|
    |  0  0   W   Z | |dw|   |r4|

by eliminating (dz, dw) into the saddle system (hqp/Hqp_IpRedSpBKP.C)

    [-H  A'] [dx]   [r1 - C'(W^-1 Z r3 + W^-1 r4)]
    [ A  0 ] [dy] = [r2]                     with  H = Q + C' W^-1 Z C,

then recovering dz = W^-1 Z (r3 - C dx) + W^-1 r4 and dw = C dx - r3.

The reference's ``lax.scan`` recursions run as Python loops over the
stages, and its ``.at[].set`` scatters as ``index_put_``.  The dense LU
runs in float64 on the QP's device (``torch.linalg.lu_factor_ex``); the
reference's f32 LU exists for the TPU alone and is not ported.
``qp_mat_solver RedSpBKP`` names the host sparse backend
(:mod:`hqp_tpu_torch.qp.kkt_sparse_host`), as it does in the reference
package once ``all_modules`` is imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hqp_tpu_torch.ops import smalllin as sl
from hqp_tpu_torch.qp.program import DenseQP, IneqGroups, StageQP
from hqp_tpu_torch.utils import log
from hqp_tpu_torch.utils import masked as mk
from hqp_tpu_torch.utils.registry import modules
from hqp_tpu_torch.utils.sync import host

#: diagonal penalty pinning fixed (min == max) variables; exactness is
#: restored by iterative refinement against the true KKT system
FIX_BIG = 1e10

#: active-set barrier cap: sigma = z/w is clipped at SIGMA_CAP where a
#: constraint goes hard-active, consistently in the Hessian fold-in, the
#: rhs reduction and the dz/dw recovery (the reference's _wz_tol split,
#: hqp/Hqp_IpLQDOCP.C:814-819); the refinement loop targets the true-z
#: residual, and its monotone guard stops it at the O(z/SIGMA_CAP) floor
SIGMA_CAP = 1e12


def barrier_ratios(z, w, mask):
    """sigma = min(z/w, SIGMA_CAP) per inequality group, zero if masked."""
    return mk.tmap(
        lambda zi, wi, m: torch.where(
            m, torch.clamp(zi / wi, max=SIGMA_CAP), 0.0),
        z, w, mask)


def _w_inv_eff(zi, wi):
    """Effective 1/w for the r4 terms: min(1/w, SIGMA_CAP/z) -- on capped
    rows the exact active-set rhs (hqp/Hqp_IpLQDOCP.C:925-932)."""
    return torch.minimum(1.0 / wi, SIGMA_CAP / torch.clamp(zi, min=1e-300))


def reduce_r1(qp, z, w, mask, r1, r3, r4):
    """r1_eff = r1 - C'(sigma_eff r3 + w_inv_eff r4), zeroed on absent
    variables."""
    t = mk.tmap(
        lambda zi, wi, r3i, r4i, m: torch.where(
            m,
            torch.clamp(zi / wi, max=SIGMA_CAP) * r3i
            + _w_inv_eff(zi, wi) * r4i,
            0.0),
        z, w, r3, r4, mask,
    )
    return torch.where(qp.x_mask(), r1 - qp.matvec_ineqT(t), 0.0)


def kkt_residual(qp, z, w, mask, r1, r2, r3, r4, dx, dy, dz, dw):
    """Residual of the full 4x4 KKT system and its infinity norm
    (Hqp_IpMatrix::residuum, hqp/Hqp_IpMatrix.C:131-180)."""
    emask = qp.eq_mask()
    e1 = torch.where(
        qp.x_mask(),
        r1 + qp.matvec_Q(dx) - qp.matvec_eqT(dy) - qp.matvec_ineqT(dz),
        0.0)
    Adx = mk.sub(qp.eval_eq(dx), qp.eq_offsets())
    e2 = mk.where(emask, mk.sub(r2, Adx), 0.0)
    Cdx = qp.matvec_ineq(dx)
    e3 = mk.where(mask, mk.tmap(lambda a, b, c: a - (b - c), r3, Cdx, dw),
                  0.0)
    e4 = mk.where(mask,
                  mk.tmap(lambda a, zi, wi, dzi, dwi: a - (zi * dwi
                                                          + wi * dzi),
                          r4, z, w, dz, dw), 0.0)
    nb = qp.nb
    res = torch.maximum(
        torch.maximum(mk.norm_inf(e1, nb=nb), mk.norm_inf(e2, emask, nb)),
        torch.maximum(mk.norm_inf(e3, mask, nb), mk.norm_inf(e4, mask, nb)))
    return e1, e2, e3, e4, res


def rhs_scale(qp, mask, r1, r2, r3, r4):
    """Masked infinity norm of the stacked KKT rhs (the scale of the
    relative refinement tolerance), one per problem of a batch."""
    nb = qp.nb
    s = mk.norm_inf(r1, qp.x_mask(), nb)
    s = torch.maximum(s, mk.norm_inf(r2, qp.eq_mask(), nb))
    s = torch.maximum(s, mk.norm_inf(r3, mask, nb))
    return torch.maximum(s, mk.norm_inf(r4, mask, nb))


#: refinement gates entered with ``max_rounds > 0`` (:func:`refine`) since
#: import (reset freely by callers)
REFINE_CALLS = 0
#: refinement rounds run since import; a round of a batch counts once
REFINE_ROUNDS = 0


def refine(solve_fn, qp, z, w, mask, r1, r2, r3, r4, sol,
           eps=1e-10, max_rounds=5, unroll=False, relative=True):
    """Iterative refinement of a KKT solve (Hqp_IpMatrix::solve,
    hqp/Hqp_IpMatrix.C:65-128): re-solve on the residual and accept the
    correction while the residual norm decreases.

    ``relative=True`` scales ``eps`` by max(1, ||rhs||_inf) (the code of
    the reference package, whose docstring describes a solution-scaled
    variant it measured and reverted); ``relative=False`` takes ``eps`` as
    an absolute bound on the residual.  ``unroll`` is accepted and
    ignored: in the reference it picks straight-line code over a
    ``lax.while_loop`` with the same result, and here the loop runs on the
    host either way.  Each test reads one small tensor
    (:func:`~hqp_tpu_torch.utils.sync.host`), one at entry and one per
    round, and the common already-accurate case exits at the entry test.
    A batched QP takes :func:`_refine_batch`.

    Every gate entered with ``max_rounds > 0`` adds one to
    :data:`REFINE_CALLS`, and every round run (accepted or not) one to
    :data:`REFINE_ROUNDS`.  The entry residual, the gate and the rounds
    are the span ``kkt.refine``, each round a ``kkt.refine.round``
    (:mod:`hqp_tpu_torch.utils.log`)."""
    global REFINE_CALLS, REFINE_ROUNDS
    del unroll
    if max_rounds <= 0:          # no round may run: the entry test is moot
        return sol
    REFINE_CALLS += 1
    with log.timers.span("kkt.refine"):
        if relative:
            eps = eps * torch.clamp(rhs_scale(qp, mask, r1, r2, r3, r4),
                                    min=1.0)
        e1, e2, e3, e4, res = kkt_residual(qp, z, w, mask, r1, r2, r3, r4,
                                           *sol)
        if qp.nb:
            return _refine_batch(solve_fn, qp, z, w, mask, (r1, r2, r3, r4),
                                 sol, (e1, e2, e3, e4), res, eps, max_rounds)
        go = host(res > eps)
        i = 0
        while go and i < max_rounds:
            with log.timers.span("kkt.refine.round"):
                REFINE_ROUNDS += 1
                cx, cy, cz, cw = solve_fn(e1, e2, e3, e4)
                dx, dy, dz, dw = sol
                new = (dx + cx, mk.add(dy, cy), mk.add(dz, cz),
                       mk.add(dw, cw))
                ne1, ne2, ne3, ne4, nres = kkt_residual(qp, z, w, mask,
                                                        r1, r2, r3, r4, *new)
                better, above = host(torch.stack([nres < res, nres > eps]))
            if not better:
                break
            sol, (e1, e2, e3, e4), res = new, (ne1, ne2, ne3, ne4), nres
            go = above
            i += 1
        return sol


def _refine_batch(solve_fn, qp, z, w, mask, rhs, sol, errs, res, eps,
                  max_rounds):
    """:func:`refine` over a batch of QPs, as ``jax.vmap`` runs the
    reference's refinement ``while_loop``: rounds run while any problem is
    live (residual above its own ``eps``, every round so far accepted,
    fewer than ``max_rounds``); each round solves for every problem and
    keeps the correction only where the problem is live and its residual
    fell.  One host read at entry and one per round.  A round adds one to
    :data:`REFINE_ROUNDS` for the whole batch and is one
    ``kkt.refine.round`` span."""
    global REFINE_ROUNDS
    live = res > eps
    i = 0
    while i < max_rounds and host(live.any()):
        with log.timers.span("kkt.refine.round"):
            REFINE_ROUNDS += 1
            cx, cy, cz, cw = solve_fn(*errs)
            dx, dy, dz, dw = sol
            new = (dx + cx, mk.add(dy, cy), mk.add(dz, cz), mk.add(dw, cw))
            *nerrs, nres = kkt_residual(qp, z, w, mask, *rhs, *new)
            better = live & (nres < res)
            sol = mk.sel(better, new, sol)
            errs = mk.sel(better, tuple(nerrs), errs)
            res = torch.where(better, nres, res)
            live = better & (nres > eps)
        i += 1
    return sol


def reduced_H_matvec(qp, z, w, mask, dx):
    """(Q + C' W^-1 Z C) dx -- the reduced Hessian operator."""
    sig = barrier_ratios(z, w, mask)
    Cdx = qp.matvec_ineq(dx)
    return qp.matvec_Q(dx) + qp.matvec_ineqT(
        mk.tmap(lambda s, c: s * c, sig, Cdx))


def stage_eq_penalty(qp: StageQP):
    """[K1, nv, nv] penalty blocks replacing the hard stage equality rows
    in the reduced Hessian: FIX_BIG on fixed-variable diagonals and
    FIX_BIG * E'E for general stage equalities (the GE_QP elimination
    role, hqp/Hqp_IpLQDOCP.C:1377), made exact by refinement."""
    fm = qp.fixed_mask().to(qp.Q.dtype)
    Hp = torch.diag_embed(fm * FIX_BIG)
    if qp.has_gen_eq():
        Em = qp.E * qp.eqg_mask[..., None]
        Hp = Hp + FIX_BIG * torch.einsum("...kem,...ken->...kmn", Em, Em)
    return Hp


def _recover_gen_multipliers(qp, resid):
    """Per-stage least-squares recovery of general-equality multipliers
    from the stationarity residual: (E E' + reg) yg = E resid, excluding
    fixed-variable columns."""
    Em = qp.E * qp.eqg_mask[..., None]
    free = (~qp.fixed_mask()).to(Em.dtype)
    Ef = Em * free[..., None, :]
    meq = qp.meq
    eye = torch.eye(meq, dtype=Em.dtype, device=Em.device)
    G = torch.einsum("...kim,...kjm->...kij", Ef, Ef)
    G = G + 1e-12 * eye + torch.diag_embed(
        1.0 - qp.eqg_mask.to(G.dtype))
    rhs = torch.einsum("...kim,...km->...ki", Ef, resid * free)
    yg = torch.linalg.solve(G, rhs[..., None])[..., 0]
    return torch.where(qp.eqg_mask, yg, 0.0)


def stage_reduce_rhs(qp, z, w, mask, r1, r2, r3, r4):
    """Head of the stage-structured base solve: the penalty-adjusted
    reduced rhs (g for recovery, g2 for the reduced solve)."""
    fm = qp.fixed_mask()
    g = reduce_r1(qp, z, w, mask, r1, r3, r4)
    g2 = g - FIX_BIG * torch.where(fm, r2["fix"], 0.0)
    if qp.has_gen_eq():
        rg = torch.where(qp.eqg_mask, r2["gen"], 0.0)
        g2 = g2 - FIX_BIG * torch.einsum("...kij,...ki->...kj", qp.E, rg)
    return g, g2


def stage_recover(qp, z, w, mask, g, dx, dyd, r2, r3, r4):
    """Tail of the stage-structured base solve: multipliers of the
    eliminated rows from exact stationarity, plus (dz, dw) recovery.
    Affine in (dx, dyd), so a base solve plus reduced-space corrections
    may run it once on the accumulated (dx, dyd)."""
    fm = qp.fixed_mask()
    Hdx = reduced_H_matvec(qp, z, w, mask, dx)
    y0 = {"dyn": dyd, "fix": torch.zeros_like(g)}
    if qp.has_gen_eq():
        y0["gen"] = torch.zeros_like(r2["gen"])
    resid = g + Hdx - qp.matvec_eqT(y0)
    dy = {"dyn": dyd}
    if qp.has_gen_eq():
        dyg = _recover_gen_multipliers(qp, resid)
        resid = resid - torch.einsum(
            "...kij,...ki->...kj", qp.E * qp.eqg_mask[..., None], dyg)
        dy["gen"] = dyg
    dy["fix"] = torch.where(fm, resid, 0.0)
    dz, dw = recover_zw(qp, z, w, mask, dx, r3, r4)
    return dx, dy, dz, dw


def stage_base_solve(solve_reduced_fn, qp, z, w, mask, r1, r2, r3, r4):
    """Base solve of the stage-structured backends: penalty-adjusted
    reduced rhs, reduced solve, multiplier recovery from exact
    stationarity (exactness comes from the caller's refinement)."""
    g, g2 = stage_reduce_rhs(qp, z, w, mask, r1, r2, r3, r4)
    dx, dyd = solve_reduced_fn(g2, r2["dyn"])
    return stage_recover(qp, z, w, mask, g, dx, dyd, r2, r3, r4)


def recover_zw(qp, z, w, mask, dx, r3, r4):
    """dz = sigma_eff (r3 - C dx) + w_inv_eff r4,  dw = C dx - r3."""
    Cdx = qp.matvec_ineq(dx)
    dz = mk.tmap(
        lambda zi, wi, r3i, r4i, ci, m: torch.where(
            m,
            torch.clamp(zi / wi, max=SIGMA_CAP) * (r3i - ci)
            + _w_inv_eff(zi, wi) * r4i,
            0.0,
        ),
        z, w, r3, r4, Cdx, mask,
    )
    dw = mk.tmap(
        lambda ci, r3i, m: torch.where(m, ci - r3i, 0.0), Cdx, r3, mask
    )
    return dz, dw


def _stage_hessians(qp: StageQP, z: IneqGroups, w: IneqGroups,
                    mask: IneqGroups) -> torch.Tensor:
    """H_k = Q_k + diag(box barrier) + C_k' Sigma C_k, [K1, nv, nv], with
    absent variables (x_mask False) projected out as identity rows."""
    sig = barrier_ratios(z, w, mask)
    diag_box = sig.bl + sig.bu                       # [K1, nv]
    sgen = sig.gl + sig.gu                           # [K1, mc]
    H = qp.Q + torch.einsum("...kmi,...km,...kmj->...kij", qp.C, sgen, qp.C)
    H = H + torch.diag_embed(diag_box)
    vm = qp.x_mask().to(H.dtype)
    H = H * vm[..., :, None] * vm[..., None, :]
    return H + torch.diag_embed(1.0 - vm)


# ---------------------------------------------------------------------------
# Riccati backend (the sequential parity oracle)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RiccatiFactors:
    Luu: torch.Tensor     # [K, nu, nu] Cholesky factors of Guu_k
    Gux: torch.Tensor     # [K, nu, nx]
    Kgain: torch.Tensor   # [K, nu, nx] Guu^-1 Gux
    P: torch.Tensor       # [K1, nx, nx] cost-to-go Hessians (P_0..P_K)
    LP0: torch.Tensor     # [nx, nx] Cholesky factor of P_0
    LuuK: torch.Tensor    # [nu, nu] Cholesky of the terminal u-block
    KgainK: torch.Tensor  # [nu, nx] HuuK^-1 HuxK


class RiccatiKKT:
    """Backward Riccati factorization of the reduced stage-structured KKT
    (hqp/Hqp_IpLQDOCP.C:796-862, :1328-1788): Cholesky of the projected
    control Hessian Guu per stage, one stage after the other.

    It cannot represent structurally absent states at stages k >= 1
    (their dynamics rows would constrain the preceding stage);
    :meth:`validate` refuses such programs.  This is the parity oracle of
    the reference's Riccati recursion, registered as ``qp_mat_solver
    Riccati``; the flagship name ``LQDOCP`` is the partitioned backend.
    """

    def __init__(self, reg: float = 0.0, refine_eps: float = 1e-10,
                 refine_rounds: int = 5):
        self.reg = reg
        self.refine_eps = refine_eps
        self.refine_rounds = refine_rounds

    def validate(self, qp):
        """Raise for structurally absent states at stages k >= 1 (one host
        read); pin such states by lb == ub instead."""
        if isinstance(qp, StageQP) and \
                not host(qp.var_mask[1:, : qp.nx].all()):
            raise ValueError(
                "RiccatiKKT (LQDOCP): structurally absent states at stage "
                "k >= 1 cannot be represented by the sequential Riccati "
                "recursion; pin them via lb == ub (exact equality rows) or "
                "use the partitioned backend (qp_mat_solver SpSC)")

    def factor(self, qp: StageQP, z, w, mask):
        nx, nu = qp.nx, qp.nu
        H = _stage_hessians(qp, z, w, mask) + stage_eq_penalty(qp)
        eyeu = self.reg * torch.eye(nu, dtype=H.dtype, device=H.device)
        # terminal stage: eliminate the (padded) u-block by Schur complement
        HK = H[-1]
        LuuK = sl.chol(HK[nx:, nx:] + eyeu)
        KgainK = sl.cho_solve(LuuK, HK[nx:, :nx])
        P = HK[:nx, :nx] - HK[:nx, nx:] @ KgainK
        P = 0.5 * (P + P.T)
        Am = qp.A_masked()
        Luu, Gux, Kg, Pn = [], [], [], []
        for k in reversed(range(qp.K)):
            Ak = Am[k]
            G = H[k] + Ak.T @ (P @ Ak)
            Gux_k = G[nx:, :nx]
            L = sl.chol(G[nx:, nx:] + eyeu)
            K_k = sl.cho_solve(L, Gux_k)
            Pn.append(P)
            P = G[:nx, :nx] - Gux_k.T @ K_k
            P = 0.5 * (P + P.T)
            Luu.append(L)
            Gux.append(Gux_k)
            Kg.append(K_k)

        def stages(lst):
            return torch.stack(lst[::-1])

        return RiccatiFactors(
            Luu=stages(Luu), Gux=stages(Gux), Kgain=stages(Kg),
            P=torch.cat([P[None], stages(Pn)]), LP0=sl.chol(P),
            LuuK=LuuK, KgainK=KgainK)

    def solve_reduced(self, fac: RiccatiFactors, qp: StageQP, g, r2):
        """Solve  H dx - A' dy = -g,  A_k v_k - dx_{k+1} = r2_k."""
        nx, K = qp.nx, qp.K
        gx, gu = g[:, :nx], g[:, nx:]
        Am = qp.A_masked()
        Ax, Au = Am[:, :, :nx], Am[:, :, nx:]
        xcm = qp.xcoupling_mask().to(g.dtype)

        # backward sweep: linear cost-to-go p_k and feedforward bu_k
        p = gx[-1] - fac.KgainK.T @ gu[-1]
        bu, pnext = [None] * K, [None] * K
        for k in reversed(range(K)):
            t = p - fac.P[k + 1] @ r2[k]
            bu[k] = sl.cho_solve(fac.Luu[k], -(gu[k] + Au[k].T @ t))
            pnext[k] = p
            p = gx[k] + Ax[k].T @ t + fac.Gux[k].T @ bu[k]

        # forward sweep: controls, states, dynamics multipliers (the
        # recursion's costate is the negative of the saddle system's dy)
        dxk = sl.cho_solve(fac.LP0, -p)
        v, dy = [], []
        for k in range(K):
            vk = torch.cat([dxk, bu[k] - fac.Kgain[k] @ dxk])
            dxk = (Am[k] @ vk - r2[k]) * xcm[k]
            v.append(vk)
            dy.append(-(fac.P[k + 1] @ dxk + pnext[k]))
        duK = -(sl.cho_solve(fac.LuuK, gu[-1]) + fac.KgainK @ dxk)
        v.append(torch.cat([dxk, duK]))
        return torch.stack(v), torch.stack(dy)

    def solve(self, fac, qp: StageQP, z, w, mask, r1, r2, r3, r4):
        def base(a1, a2, a3, a4):
            return stage_base_solve(
                lambda g, r2d: self.solve_reduced(fac, qp, g, r2d),
                qp, z, w, mask, a1, a2, a3, a4)

        sol = base(r1, r2, r3, r4)
        if self.refine_rounds > 0:
            sol = refine(base, qp, z, w, mask, r1, r2, r3, r4, sol,
                         eps=self.refine_eps, max_rounds=self.refine_rounds)
        return sol


modules.register("qp_mat_solver", "Riccati")(RiccatiKKT)


# ---------------------------------------------------------------------------
# dense backends
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DenseFactors:
    lu: torch.Tensor
    piv: torch.Tensor


def _saddle_factor(H, A, eq_mask):
    """LU-factor [[-H, A'], [A, 0]] with masked eq rows replaced by
    identity rows."""
    Am = A * eq_mask[:, None]
    Z = torch.diag((~eq_mask).to(H.dtype))
    J = torch.cat([torch.cat([-H, Am.T], dim=1),
                   torch.cat([Am, Z], dim=1)], dim=0)
    # no singularity check: a zero pivot propagates inf/NaN into the
    # directions, which the interior point reports as degenerate (as the
    # reference's LU does); the check would also cost a host sync
    lu, piv, _ = torch.linalg.lu_factor_ex(J)
    return DenseFactors(lu=lu, piv=piv)


def _saddle_solve(fac: DenseFactors, n, r1_eff, r2):
    rhs = torch.cat([r1_eff, r2])
    sol = torch.linalg.lu_solve(fac.lu, fac.piv, rhs[:, None])[:, 0]
    return sol[:n], sol[n:]


class DenseKKT:
    """Dense reduced-system backend for :class:`DenseQP` (the role of the
    reference's default Hqp_IpRedSpBKP, hqp/Hqp_IpRedSpBKP.C: eliminate
    (z, w), factor J = [-(Q + C'W^-1Z C), A'; A, 0]) by one dense LU."""

    def __init__(self, refine_eps: float = 1e-10, refine_rounds: int = 5):
        self.refine_eps = refine_eps
        self.refine_rounds = refine_rounds

    def factor(self, qp: DenseQP, z, w, mask):
        sig = barrier_ratios(z, w, mask)
        H = qp.Q + (qp.C.T * sig.g) @ qp.C
        return _saddle_factor(H, qp.A, qp.eq_mask_)

    def solve(self, fac, qp: DenseQP, z, w, mask, r1, r2, r3, r4):
        def base(a1, a2, a3, a4):
            g = reduce_r1(qp, z, w, mask, a1, a3, a4)
            r2m = torch.where(qp.eq_mask_, a2, 0.0)
            dx, dy = _saddle_solve(fac, qp.n, g, r2m)
            dz, dw = recover_zw(qp, z, w, mask, dx, a3, a4)
            return dx, dy, dz, dw

        sol = base(r1, r2, r3, r4)
        if self.refine_rounds > 0:
            sol = refine(base, qp, z, w, mask, r1, r2, r3, r4, sol,
                         eps=self.refine_eps, max_rounds=self.refine_rounds)
        return sol


modules.register("qp_mat_solver", "DenseKKT")(DenseKKT)


class FullStageKKT:
    """Verification backend: lowers a StageQP to one dense saddle system
    (the role of the reference's full-matrix variants,
    hqp/Hqp_IpFullSpLU)."""

    @staticmethod
    def dense_blocks(qp: StageQP, Hb):
        """Lowering of the stage blocks to one dense (H, A)."""
        K1, nv = Hb.shape[0], Hb.shape[1]
        K, nx = qp.K, qp.nx
        n = K1 * nv
        f = dict(dtype=Hb.dtype, device=Hb.device)

        def idx(a, shape):
            return torch.tensor(np.broadcast_to(a, shape).reshape(-1),
                                device=Hb.device)

        # block-diagonal H by one scatter
        base = np.arange(K1)[:, None, None] * nv
        shape3 = (K1, nv, nv)
        H = torch.zeros((n, n), **f).index_put_(
            (idx(base + np.arange(nv)[None, :, None], shape3),
             idx(base + np.arange(nv)[None, None, :], shape3)),
            Hb.reshape(-1))
        # dynamics rows [A_k | -I] by two scatters
        rb = np.arange(K)[:, None, None] * nx
        shapeA = (K, nx, nv)
        A = torch.zeros((K * nx, n), **f).index_put_(
            (idx(rb + np.arange(nx)[None, :, None], shapeA),
             idx(np.arange(K)[:, None, None] * nv
                 + np.arange(nv)[None, None, :], shapeA)),
            qp.A_masked().reshape(-1))
        ir = (rb + np.arange(nx)[None, :, None])[:, :, 0]
        ic = np.arange(1, K + 1)[:, None] * nv + np.arange(nx)[None, :]
        A = A.index_put_(
            (idx(ir, ir.shape), idx(ic, ic.shape)),
            -qp.xcoupling_mask().to(A.dtype).reshape(-1), accumulate=True)
        return H, A

    @staticmethod
    def _gen_eq_rows(qp: StageQP):
        """Block-diagonal lowering of the per-stage general equality rows
        E [K1, meq, nv] into dense rows [K1*meq, n] and their mask."""
        K1, meq, nv = qp.E.shape
        shape = (K1, meq, nv)
        rr = np.broadcast_to(np.arange(K1)[:, None, None] * meq
                             + np.arange(meq)[None, :, None], shape)
        cc = np.broadcast_to(np.arange(K1)[:, None, None] * nv
                             + np.arange(nv)[None, None, :], shape)
        Em = qp.E * qp.eqg_mask[:, :, None]
        G = torch.zeros((K1 * meq, K1 * nv), dtype=Em.dtype,
                        device=Em.device).index_put_(
            (torch.as_tensor(rr.reshape(-1), device=Em.device),
             torch.as_tensor(cc.reshape(-1), device=Em.device)),
            Em.reshape(-1))
        # rows with an identically zero Jacobian would make the hard
        # saddle system singular; the penalty backends drop them (E'E = 0),
        # so the oracle deactivates them too (their dy stays 0)
        live = Em.abs().sum(dim=2) > 0.0
        return G, (qp.eqg_mask & live).reshape(-1)

    def factor(self, qp: StageQP, z, w, mask):
        H, A = self.dense_blocks(qp, _stage_hessians(qp, z, w, mask))
        n = H.shape[0]
        # fixed-variable equality rows: identity rows masked by fixed_mask
        rows = [A, torch.eye(n, dtype=H.dtype, device=H.device)]
        masks = [torch.ones(A.shape[0], dtype=torch.bool, device=H.device),
                 qp.fixed_mask().reshape(-1)]
        if qp.has_gen_eq():
            G, gmask = self._gen_eq_rows(qp)
            rows.append(G)
            masks.append(gmask)
        return _saddle_factor(H, torch.cat(rows), torch.cat(masks))

    def solve(self, fac, qp: StageQP, z, w, mask, r1, r2, r3, r4):
        g = reduce_r1(qp, z, w, mask, r1, r3, r4)
        K1, nv = qp.K + 1, qp.nv
        n = K1 * nv
        fm = qp.fixed_mask().reshape(-1)
        parts = [r2["dyn"].reshape(-1),
                 torch.where(fm, r2["fix"].reshape(-1), 0.0)]
        if qp.has_gen_eq():
            _, gmask = self._gen_eq_rows(qp)
            parts.append(torch.where(gmask, r2["gen"].reshape(-1), 0.0))
        dxf, dyf = _saddle_solve(fac, n, g.reshape(-1), torch.cat(parts))
        dx = dxf.reshape(K1, nv)
        ndyn = qp.K * qp.nx
        dy = {"dyn": dyf[:ndyn].reshape(qp.K, qp.nx),
              "fix": torch.where(fm, dyf[ndyn:ndyn + n], 0.0).reshape(K1,
                                                                      nv)}
        if qp.has_gen_eq():
            dy["gen"] = torch.where(gmask, dyf[ndyn + n:],
                                    0.0).reshape(K1, qp.meq)
        dz, dw = recover_zw(qp, z, w, mask, dx, r3, r4)
        return dx, dy, dz, dw


modules.register("qp_mat_solver", "FullKKT")(FullStageKKT)

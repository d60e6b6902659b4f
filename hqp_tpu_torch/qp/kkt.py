"""Shared KKT reduction helpers of the interior-point solver.

Port of the backend-generic part of ``hqp_tpu/qp/kkt.py`` (the Riccati,
dense and full-stage backends are not ported yet).  Every backend solves
the per-iteration KKT system (hqp/Hqp_IpMatrix.h:42-89)

    | -Q  A'  C'  0 | |dx|   |r1|
    |  A  0   0   0 | |dy|   |r2|
    |  C  0   0  -I | |dz| = |r3|
    |  0  0   W   Z | |dw|   |r4|

by eliminating (dz, dw) into the saddle system (hqp/Hqp_IpRedSpBKP.C)

    [-H  A'] [dx]   [r1 - C'(W^-1 Z r3 + W^-1 r4)]
    [ A  0 ] [dy] = [r2]                     with  H = Q + C' W^-1 Z C,

then recovering dz = W^-1 Z (r3 - C dx) + W^-1 r4 and dw = C dx - r3.
"""

from __future__ import annotations

import torch

from hqp_tpu_torch.qp.program import IneqGroups, StageQP
from hqp_tpu_torch.utils import masked as mk
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
    res = torch.maximum(
        torch.maximum(mk.norm_inf(e1), mk.norm_inf(e2, emask)),
        torch.maximum(mk.norm_inf(e3, mask), mk.norm_inf(e4, mask)))
    return e1, e2, e3, e4, res


def rhs_scale(qp, mask, r1, r2, r3, r4):
    """Masked infinity norm of the stacked KKT rhs (the scale of the
    relative refinement tolerance)."""
    s = mk.norm_inf(r1, qp.x_mask())
    s = torch.maximum(s, mk.norm_inf(r2, qp.eq_mask()))
    s = torch.maximum(s, mk.norm_inf(r3, mask))
    return torch.maximum(s, mk.norm_inf(r4, mask))


def refine(solve_fn, qp, z, w, mask, r1, r2, r3, r4, sol,
           eps=1e-10, max_rounds=5):
    """Iterative refinement of a KKT solve (Hqp_IpMatrix::solve,
    hqp/Hqp_IpMatrix.C:65-128): re-solve on the residual and accept the
    correction while the residual norm decreases.

    ``eps`` is scaled by max(1, ||rhs||_inf) (the code of the reference
    package, whose docstring describes a solution-scaled variant it
    measured and reverted).  The loop runs on the host: each test reads
    one small tensor (:func:`~hqp_tpu_torch.utils.sync.host`), one at
    entry and one per round, and the common already-accurate case exits
    at the entry test."""
    eps = eps * torch.clamp(rhs_scale(qp, mask, r1, r2, r3, r4), min=1.0)
    e1, e2, e3, e4, res = kkt_residual(qp, z, w, mask, r1, r2, r3, r4, *sol)
    go = host(res > eps)
    i = 0
    while go and i < max_rounds:
        cx, cy, cz, cw = solve_fn(e1, e2, e3, e4)
        dx, dy, dz, dw = sol
        new = (dx + cx, mk.add(dy, cy), mk.add(dz, cz), mk.add(dw, cw))
        ne1, ne2, ne3, ne4, nres = kkt_residual(qp, z, w, mask,
                                                r1, r2, r3, r4, *new)
        better, above = host(torch.stack([nres < res, nres > eps]))
        if not better:
            break
        sol, (e1, e2, e3, e4), res = new, (ne1, ne2, ne3, ne4), nres
        go = above
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
        Em = qp.E * qp.eqg_mask[:, :, None]
        Hp = Hp + FIX_BIG * torch.einsum("kem,ken->kmn", Em, Em)
    return Hp


def _recover_gen_multipliers(qp, resid):
    """Per-stage least-squares recovery of general-equality multipliers
    from the stationarity residual: (E E' + reg) yg = E resid, excluding
    fixed-variable columns."""
    Em = qp.E * qp.eqg_mask[:, :, None]
    free = (~qp.fixed_mask()).to(Em.dtype)
    Ef = Em * free[:, None, :]
    meq = qp.meq
    eye = torch.eye(meq, dtype=Em.dtype, device=Em.device)
    G = torch.einsum("kim,kjm->kij", Ef, Ef)
    G = G + 1e-12 * eye + torch.diag_embed(
        1.0 - qp.eqg_mask.to(G.dtype))
    rhs = torch.einsum("kim,km->ki", Ef, resid * free)
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
        g2 = g2 - FIX_BIG * torch.einsum("kij,ki->kj", qp.E, rg)
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
            "kij,ki->kj", qp.E * qp.eqg_mask[:, :, None], dyg)
        dy["gen"] = dyg
    dy["fix"] = torch.where(fm, resid, 0.0)
    dz, dw = recover_zw(qp, z, w, mask, dx, r3, r4)
    return dx, dy, dz, dw


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
    H = qp.Q + torch.einsum("kmi,km,kmj->kij", qp.C, sgen, qp.C)
    H = H + torch.diag_embed(diag_box)
    vm = qp.x_mask().to(H.dtype)
    H = H * vm[:, :, None] * vm[:, None, :]
    return H + torch.diag_embed(1.0 - vm)

"""Plain reference of a stage-structured QP: presolve, optimality
certificate and the original rows' violation.

A QP is a dict of tensors with optional leading batch axes (the names of
the stage form that the DOCP programs assemble):

    minimize    sum_k 1/2 v_k' Q_k v_k + c_k' v_k
    subject to  A_k v_k - x_{k+1} + b_k = 0          k = 0..K-1
                lb_k <= v_k <= ub_k                   (box; lb == ub fixes)
                d_lo_k <= C_k v_k <= d_up_k           (general rows)

with Q [K1, nv, nv], c [K1, nv], A [K, nx, nv], b [K, nx], lb/ub [K1, nv],
C [K1, mc, nv], d_lo/d_up [K1, mc], var_mask [K1, nv] and con_mask
[K1, mc].  Infinite bounds mark absent rows; absent variables (var_mask
False) carry no row.

A solution is judged by the certificate an interior-point method's own
termination test states (HQP's Mehrotra: mu <= eps and the largest KKT
residual <= eps times the largest datum), recomputed here from this QP
and the solution's primal x, equality multipliers y ({"dyn", "fix"}),
inequality multipliers z and slacks w ({"bl", "bu", "gl", "gu"}).

Plain torch only: this module imports nothing of the program under test.
"""

from __future__ import annotations

import torch

GROUPS = ("bl", "bu", "gl", "gu")


def _z(a):
    """+-inf -> 0 (offsets of absent rows)."""
    return torch.where(torch.isfinite(a), a, 0.0)


def _amax(t, nb):
    """Largest entry of each problem: reduce every axis behind ``nb``."""
    if t.numel() == 0:
        return t.new_zeros(t.shape[:nb])
    return t.reshape(t.shape[:nb] + (-1,)).amax(-1)


def fixed_mask(qp):
    return (torch.isfinite(qp["lb"]) & torch.isfinite(qp["ub"])
            & (qp["lb"] == qp["ub"]) & qp["var_mask"])


def ineq_masks(qp):
    fix = fixed_mask(qp)
    return {"bl": torch.isfinite(qp["lb"]) & qp["var_mask"] & ~fix,
            "bu": torch.isfinite(qp["ub"]) & qp["var_mask"] & ~fix,
            "gl": torch.isfinite(qp["d_lo"]) & qp["con_mask"],
            "gu": torch.isfinite(qp["d_up"]) & qp["con_mask"]}


def presolve(qp, tau):
    """Fold every general row whose off-axis mass is at most ``tau`` times
    its largest coefficient into that variable's box bound, and drop the
    row (the tau-parallel merge of HQP's DID path row into its box row)."""
    C = qp["C"]
    absC = C.abs()
    imax = torch.argmax(absC, dim=-1)
    cmax = absC.gather(-1, imax[..., None])[..., 0]
    par = (cmax > 0.0) & (absC.sum(-1) - cmax <= tau * cmax) \
        & qp["con_mask"]
    lb, ub = qp["lb"], qp["ub"]
    d_lo, d_up = qp["d_lo"].clone(), qp["d_up"].clone()
    cols = torch.arange(C.shape[-1], device=C.device)
    for e in range(C.shape[-2]):
        i = imax[..., e]
        hot = cols == i[..., None]
        ci = C[..., e, :].gather(-1, i[..., None])[..., 0]
        pe = par[..., e]
        cs = torch.where(ci == 0.0, 1.0, ci)
        for bound, sign in ((qp["d_up"][..., e], 1.0),
                            (qp["d_lo"][..., e], -1.0)):
            fin = torch.isfinite(bound) & pe
            val = (bound / cs)[..., None]
            # an upper row bounds v_i above where c_i > 0, below where
            # c_i < 0; a lower row the other way round
            upper = fin & (sign * ci > 0.0)
            lower = fin & (sign * ci < 0.0)
            ub = torch.where(hot & upper[..., None],
                             torch.minimum(ub, val), ub)
            lb = torch.where(hot & lower[..., None],
                             torch.maximum(lb, val), lb)
        d_up[..., e] = torch.where(pe, float("inf"), d_up[..., e])
        d_lo[..., e] = torch.where(pe, float("-inf"), d_lo[..., e])
    return dict(qp, lb=lb, ub=ub, d_lo=d_lo, d_up=d_up)


def norm_data(qp, nb):
    """The largest datum of each problem: Q, A, C, c, the fixed values,
    the present bounds and offsets (the relative termination scale)."""
    m = ineq_masks(qp)
    fix = fixed_mask(qp)
    terms = [_amax(qp["Q"].abs(), nb), _amax(qp["A"].abs(), nb),
             _amax(qp["C"].abs(), nb), _amax(qp["b"].abs(), nb),
             _amax(torch.where(qp["var_mask"], qp["c"].abs(), 0.0), nb),
             _amax(torch.where(fix, _z(qp["lb"]).abs(), 0.0), nb)]
    for key, g in (("lb", "bl"), ("ub", "bu"), ("d_lo", "gl"),
                   ("d_up", "gu")):
        terms.append(_amax(torch.where(m[g], _z(qp[key]).abs(), 0.0), nb))
    return torch.clamp(torch.stack(terms, dim=-1).amax(-1), min=1e-10)


def certificate(qp, x, y, z, w):
    """(primal, dual, mu) of each problem at the solution (x, y, z, w):
    the largest equality residual or slack gap |w - g(x)| (or negative
    slack), relative to :func:`norm_data`; the largest stationarity
    residual (or negative multiplier), relative likewise; and the mean
    complementarity z'w over the present inequality rows."""
    nb = x.dim() - 2
    nx = qp["A"].shape[-2]
    m = ineq_masks(qp)
    fix = fixed_mask(qp)
    Q, A, C = qp["Q"], qp["A"], qp["C"]

    # equality residuals: dynamics and fixed variables
    dyn = torch.einsum("...kij,...kj->...ki", A, x[..., :-1, :]) \
        - x[..., 1:, :nx] + qp["b"]
    fixr = torch.where(fix, x - _z(qp["lb"]), 0.0)
    # one-sided inequality values g(x) >= 0
    Cx = torch.einsum("...kij,...kj->...ki", C, x)
    g = {"bl": x - _z(qp["lb"]), "bu": _z(qp["ub"]) - x,
         "gl": Cx - _z(qp["d_lo"]), "gu": _z(qp["d_up"]) - Cx}
    slack = [torch.where(m[k], (w[k] - g[k]).abs(), 0.0) for k in GROUPS]
    negw = [torch.where(m[k], -w[k], 0.0) for k in GROUPS]
    primal = torch.stack([_amax(t, nb) for t in
                         [dyn.abs(), fixr.abs()] + slack + negw],
                         dim=-1).amax(-1)

    # stationarity: Q x + c - (equality Jacobian)' y - (inequality
    # Jacobian)' z on the present variables
    eqT = torch.zeros_like(x)
    eqT[..., :-1, :] += torch.einsum("...kij,...ki->...kj", A, y["dyn"])
    eqT[..., 1:, :nx] -= y["dyn"]
    eqT = eqT + torch.where(fix, y["fix"], 0.0)
    zm = {k: torch.where(m[k], z[k], 0.0) for k in GROUPS}
    ineqT = zm["bl"] - zm["bu"] + torch.einsum(
        "...kij,...ki->...kj", C, zm["gl"] - zm["gu"])
    r1 = torch.where(qp["var_mask"],
                     torch.einsum("...kij,...kj->...ki", Q, x) + qp["c"]
                     - eqT - ineqT, 0.0)
    negz = [torch.where(m[k], -z[k], 0.0) for k in GROUPS]
    dual = torch.stack([_amax(t, nb) for t in [r1.abs()] + negz],
                       dim=-1).amax(-1)

    scale = norm_data(qp, nb)
    rows = sum(m[k].flatten(nb).sum(-1).to(x.dtype) for k in GROUPS)
    zw = sum(torch.where(m[k], z[k] * w[k], 0.0).flatten(nb).sum(-1)
             for k in GROUPS)
    mu = zw / torch.clamp(rows, min=1.0)
    return primal / scale, dual / scale, mu


def row_violation(qp, x):
    """Largest violation of the general rows of ``qp`` at ``x``, one per
    problem (0 where every row holds)."""
    nb = x.dim() - 2
    Cx = torch.einsum("...kij,...kj->...ki", qp["C"], x)
    up = torch.where(torch.isfinite(qp["d_up"]) & qp["con_mask"],
                     Cx - qp["d_up"], float("-inf"))
    lo = torch.where(torch.isfinite(qp["d_lo"]) & qp["con_mask"],
                     qp["d_lo"] - Cx, float("-inf"))
    worst = _amax(torch.maximum(up, lo), nb)
    return torch.clamp(worst, min=0.0)


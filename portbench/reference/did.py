"""Plain reference of HQP's DID program (hqp_docp/Prg_DID.C): the double
integrator with its path constraint, written from the model's equations.

    stages k = 0..K, dt = 1/K, v_k = (x_k, u_k), u_K padding (absent)
    dynamics  x0' = x0 + u dt,   x1' = x0 dt + x1 + u dt^2/2
    cost      sum u^2 dt
    x(0) = (1, 0) pinned, x(K) = (-1, 0) fixed, x1 <= 0.01 on 1..K-1,
    with_cns: c = x1 + dt/2 x0 <= 0.01 on 0..K-1

The linearization of the program at an iterate v, with a given Hessian
Q, is the stage QP of :mod:`portbench.reference.stageqp`; the dynamics
are linear, so its Jacobians are constants.  Everything is computed in
the dtype of ``v``.  Plain torch only: nothing of the program under test
is imported.
"""

from __future__ import annotations

import torch

NX, NU = 2, 1
NV = NX + NU


def _static(cfg, device, dtype):
    """Bounds and masks of the iterate's stage layout."""
    K = cfg["kmax"]
    inf = float("inf")
    f = dict(dtype=dtype, device=device)
    lb = torch.full((K + 1, NV), -inf, **f)
    ub = torch.full((K + 1, NV), inf, **f)
    ub[1:K, 1] = 0.01                               # path bound on x1
    lb[K, :NX] = ub[K, :NX] = torch.tensor([-1.0, 0.0], **f)
    var_mask = torch.ones((K + 1, NV), dtype=torch.bool, device=device)
    var_mask[0, :NX] = False                        # x(0) pinned
    var_mask[K, NX:] = False                        # u_K padding
    lb = torch.where(var_mask, lb, -inf)
    ub = torch.where(var_mask, ub, inf)
    c_max = torch.full((K + 1, 1), inf, **f)
    if cfg.get("with_cns", True):
        c_max[:K, 0] = 0.01
    c_min = torch.full((K + 1, 1), -inf, **f)
    con_mask = torch.isfinite(c_max)
    return lb, ub, c_min, c_max, var_mask, con_mask


def base_iterate(cfg, device):
    """The program's initial iterate: x = (1, 0) and u = -2 at every
    stage, clipped into the bounds, x(0) at its pinned value and the
    padding u_K at 0 (float64)."""
    K = cfg["kmax"]
    v = torch.tensor([1.0, 0.0, -2.0], dtype=torch.float64,
                     device=device).repeat(K + 1, 1)
    v[K, NX:] = 0.0
    lb, ub, *_ = _static(cfg, device, torch.float64)
    return torch.clamp(v, lb, ub)


def build_qp(cfg, v, Q):
    """The stage QP at iterate(s) v [..., K+1, 3] with Hessians Q
    [..., K+1, 3, 3], in v's dtype."""
    K = cfg["kmax"]
    dt = 1.0 / K
    dtype, device = v.dtype, v.device
    lead = v.shape[:-2]
    lb, ub, c_min, c_max, var_mask, con_mask = _static(cfg, device, dtype)
    x0, x1, u = v[..., 0], v[..., 1], v[..., 2]

    nxt = torch.stack([x0[..., :-1] + u[..., :-1] * dt,
                       x0[..., :-1] * dt + x1[..., :-1]
                       + u[..., :-1] * 0.5 * dt * dt], dim=-1)
    b = nxt - v[..., 1:, :NX]
    A = torch.tensor([[1.0, 0.0, dt], [dt, 1.0, 0.5 * dt * dt]],
                     dtype=dtype, device=device).expand(lead + (K, NX, NV))
    c = torch.zeros_like(v)
    c[..., NX] = 2.0 * u * dt                       # d(u^2 dt)/du
    C = torch.tensor([[0.5 * dt, 1.0, 0.0]], dtype=dtype,
                     device=device).expand(lead + (K + 1, 1, NV))
    cval = (x1 + 0.5 * dt * x0)[..., None]
    if not cfg.get("with_cns", True):
        C = torch.zeros_like(C)
        cval = torch.zeros_like(cval)
    return dict(Q=Q.to(dtype), c=c, A=A.contiguous(), b=b, lb=lb - v,
                ub=ub - v, C=C.contiguous(), d_lo=c_min - cval,
                d_up=c_max - cval,
                var_mask=var_mask.expand(lead + var_mask.shape),
                con_mask=con_mask.expand(lead + con_mask.shape))

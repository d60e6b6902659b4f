"""Plain reference of HQP's container crane (odc/Prg_Crane.C), written
from the model's equations.

A trolley of mass md carries a load of mass ml on a rope of length l; the
crane moves the load 25 m in the least time.  With the final time tf as a
state, time runs over [0, 1] and every rate is scaled by tf
(Prg_Crane.C:178-203):

    states  x = (tf, phi, omega, v, s, uc), input u (the rate of uc)
    den     = md + ml sin(phi)^2
    omega'  = -((md + ml) g sin(phi) + ml l omega^2 sin(2 phi) / 2
                + Fscale uc cos(phi)) / (l den)
    v'      = (ml g sin(2 phi) / 2 + ml l omega^2 sin(phi) + Fscale uc)
              / den
    x'      = tf (0, omega, omega', v', v, u)

with g 9.81, l 10, md 1000, ml 4000, Fscale 1000.  The bounds and the
initial guess are those of Prg_Crane.C:17-123: tf >= 1; phi, omega, v, s
fixed to (0, 0, 0, 25) at stage 0 and to (0, 0, 0, 0) at stage K; |phi|
<= 5 degrees and 0 <= s <= 25 on stages 1..K-1; |uc| <= 5; the guess tf
15, uc -/+ 100 (md + ml) / Fscale / 15^2 in the first/second half and the
jump of u at the middle stage.  The objective is tf at stage K.

Each stage's map is four classical Runge-Kutta steps (RK4) on the
uniform grid t_k = k / K; tf passes through unchanged.  The map's
Jacobian A = [df/dx, df/du] comes from RK4's own forward-sensitivity
recursion, with the right side's Jacobian written out by hand.

Departures from the C source, each the program's stage-QP layout or this
benchmark's fixed choices:

- the integrator is fixed: RK4 at 4 steps a stage, the program's default,
  where the C source leaves it to the run script;
- the sensitivities are those of the discrete RK4 map, not of the ODE;
- pi is 3.14159 in the swing bound, as the program states it;
- stage-0 fixed states are pinned (no QP variable), the stage-K control
  is padding (absent), and the QP carries one masked-off general row,
  since the crane has none (mc = 0);
- the Hessian is given (``Q``), not the Lagrangian's.

Everything is computed in the dtype of ``v``.  Plain torch only: nothing
of the program under test is imported.
"""

from __future__ import annotations

import math

import torch

# one rule for float32 matrix products on the card: no TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NX, NU = 6, 1
NV = NX + NU
STEPS = 4                       # RK4 steps a stage
G, L, MD, ML, FSCALE = 9.81, 10.0, 1000.0, 4000.0, 1000.0
MDL = MD + ML
TF_GUESS, U_BOUND = 15.0, 5.0
PHI_BOUND = 5.0 / 180.0 * 3.14159
S0 = 25.0                       # the load's start, m


def _static(cfg, device, dtype):
    """Bounds and masks of the iterate's stage layout."""
    K = cfg["K"]
    inf = math.inf
    f = dict(dtype=dtype, device=device)
    lb = torch.full((K + 1, NV), -inf, **f)
    ub = torch.full((K + 1, NV), inf, **f)
    fixed0 = torch.tensor([0.0, 0.0, 0.0, S0], **f)
    lb[0, 1:5] = ub[0, 1:5] = fixed0
    lb[K, 1:5] = ub[K, 1:5] = 0.0
    lb[1:K, 1], ub[1:K, 1] = -PHI_BOUND, PHI_BOUND
    lb[1:K, 4], ub[1:K, 4] = 0.0, S0
    lb[:, 0] = 1.0
    lb[:, 5], ub[:, 5] = -U_BOUND, U_BOUND
    var_mask = torch.ones((K + 1, NV), dtype=torch.bool, device=device)
    var_mask[0, 1:5] = False                        # stage-0 states pinned
    var_mask[K, NX:] = False                        # u_K padding
    pins = torch.zeros((K + 1, NV), **f)
    pins[0, 1:5] = fixed0
    lb = torch.where(var_mask, lb, -inf)
    ub = torch.where(var_mask, ub, inf)
    return lb, ub, var_mask, pins


def base_iterate(cfg, device):
    """The initial guess of Prg_Crane.C:105-123 clipped into the bounds,
    the stage-0 states at their pinned values and the padding u_K at 0
    (float64)."""
    K = cfg["K"]
    f = dict(dtype=torch.float64, device=device)
    lb, ub, var_mask, pins = _static(cfg, device, torch.float64)
    v = torch.zeros((K + 1, NV), **f)
    v[:, 0] = TF_GUESS
    u_guess = 100.0 * MDL / FSCALE / TF_GUESS ** 2
    half = K // 2
    v[:half + 1, 5] = -u_guess
    v[half + 1:, 5] = u_guess
    v[half, NX] = 2.0 * u_guess / (TF_GUESS / K)
    v = torch.clamp(v, lb, ub)
    return torch.where(var_mask, v, pins)


def rhs(x, u):
    """The scaled right side x' and its Jacobians d/dx [..., 6, 6] and
    d/du [..., 6, 1] at states x [..., 6] and inputs u [..., 1]."""
    tf, phi, om, vel, uc = x[..., 0], x[..., 1], x[..., 2], x[..., 3], \
        x[..., 5]
    sp, cp = torch.sin(phi), torch.cos(phi)
    s2, c2 = torch.sin(2 * phi), torch.cos(2 * phi)
    om2 = om * om
    den = MD + ML * sp * sp
    n_om = -(MDL * G * sp + 0.5 * ML * L * om2 * s2 + uc * FSCALE * cp)
    n_v = 0.5 * ML * G * s2 + ML * L * om2 * sp + uc * FSCALE
    d_om = n_om / (L * den)
    d_v = n_v / den
    zero = torch.zeros_like(phi)
    p = torch.stack([zero, om, d_om, d_v, vel, u[..., 0]], dim=-1)

    # d den/d phi, and the numerators' partial derivatives
    den_phi = ML * s2
    n_om_phi = -(MDL * G * cp + ML * L * om2 * c2 - uc * FSCALE * sp)
    n_om_om = -ML * L * om * s2
    n_v_phi = ML * G * c2 + ML * L * om2 * cp
    n_v_om = 2.0 * ML * L * om * sp
    dp = torch.zeros(x.shape + (NX,), dtype=x.dtype, device=x.device)
    dp[..., 1, 2] = 1.0
    dp[..., 2, 1] = (n_om_phi * den - n_om * den_phi) / (L * den * den)
    dp[..., 2, 2] = n_om_om / (L * den)
    dp[..., 2, 5] = -FSCALE * cp / (L * den)
    dp[..., 3, 1] = (n_v_phi * den - n_v * den_phi) / (den * den)
    dp[..., 3, 2] = n_v_om / den
    dp[..., 3, 5] = FSCALE / den
    dp[..., 4, 3] = 1.0
    # x' = tf p: the product rule puts p in tf's column
    jx = tf[..., None, None] * dp
    jx[..., 1:, 0] += p[..., 1:]
    ju = torch.zeros(x.shape + (NU,), dtype=x.dtype, device=x.device)
    ju[..., 5, 0] = tf
    return tf[..., None] * p, jx, ju


def rk4(x, u, h):
    """The stage map: STEPS RK4 steps of size h [K] from x [..., K, 6]
    under u [..., K, 1], with its Jacobian [..., K, 6, 7] with respect to
    (x, u) by the forward-sensitivity recursion."""
    h = h.to(x.dtype)[:, None]
    hs = h[..., None]
    eye = torch.eye(NX, NV, dtype=x.dtype, device=x.device)
    sens = eye.expand(x.shape[:-1] + (NX, NV))
    e_u = torch.zeros((NU, NV), dtype=x.dtype, device=x.device)
    e_u[0, NX] = 1.0

    def slope(xs, ss):
        f, jx, ju = rhs(xs, u)
        return f, jx @ ss + ju @ e_u

    xs = x
    for _ in range(STEPS):
        k1, s1 = slope(xs, sens)
        k2, s2 = slope(xs + 0.5 * h * k1, sens + 0.5 * hs * s1)
        k3, s3 = slope(xs + 0.5 * h * k2, sens + 0.5 * hs * s2)
        k4, s4 = slope(xs + h * k3, sens + hs * s3)
        xs = xs + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        sens = sens + (hs / 6.0) * (s1 + 2 * s2 + 2 * s3 + s4)
    return xs, sens


def build_qp(cfg, v, Q):
    """The stage QP at iterate(s) v [..., K+1, 7] with Hessians Q
    [..., K+1, 7, 7], in v's dtype."""
    K = cfg["K"]
    dtype, device = v.dtype, v.device
    lead = v.shape[:-2]
    lb, ub, var_mask, _ = _static(cfg, device, dtype)
    ts = torch.arange(K + 1, dtype=torch.float64, device=device) / K
    h = (ts[1:] - ts[:-1]) / STEPS
    nxt, A = rk4(v[..., :-1, :NX], v[..., :-1, NX:], h)
    b = nxt - v[..., 1:, :NX]
    c = torch.zeros_like(v)
    c[..., K, 0] = 1.0                              # d tf / d tf at stage K
    inf = math.inf
    C = torch.zeros(lead + (K + 1, 1, NV), dtype=dtype, device=device)
    d_lo = torch.full(lead + (K + 1, 1), -inf, dtype=dtype, device=device)
    con_mask = torch.zeros((K + 1, 1), dtype=torch.bool, device=device)
    return dict(Q=Q.to(dtype), c=c, A=A.contiguous(), b=b, lb=lb - v,
                ub=ub - v, C=C, d_lo=d_lo, d_up=-d_lo,
                var_mask=var_mask.expand(lead + var_mask.shape),
                con_mask=con_mask.expand(lead + con_mask.shape))

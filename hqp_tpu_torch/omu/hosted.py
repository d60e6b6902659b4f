"""Hosted models: external (non-torch) models inside the port's compute path.

Port of ``hqp_tpu/omu/hosted.py``.  Bridges an hxi evaluator (compiled
S-function, Python S-function or FMU -- :mod:`hqp_tpu_torch.hxi`) into
the :class:`hqp_tpu_torch.omu.model.Model` protocol that the
DynamicOpt/DynamicEst/DTOpt formulations consume.  The reference crosses
the device boundary with ``jax.pure_callback`` (sequential under vmap)
inside a ``jax.custom_jvp`` whose rule fetches the model Jacobian from the
host.  Here two ``torch.autograd.Function``\\ s take those roles, one for
the values and one for the Jacobians; each has a ``jvp`` and an explicit
``vmap`` rule, since ``Docp.eval_derivs`` runs ``vmap(jacfwd(stage))``
over the K stages:

* the ``vmap`` rule takes the whole batch of stages to the host in ONE
  counted read (``utils/sync.to_host``), loops over the stages in numpy,
  and sends one tensor back; ``HostedModel.moved`` counts the bytes each
  way, as the host-sparse KKT backends do;
* each stage calls the same C function on the same inputs as the
  reference (the evaluators set every input before every call, so the
  batch order leaks no state between stages), and the Jacobian is the
  model's own where it provides one (FMU fmi2GetDirectionalDerivative --
  the reference's mdl_jac path, omu/Omu_Model.C setup_jac), else central
  finite differences with the reference's perturbation size policy
  (hqp/Hqp_Docp.C:1098: dv = 1e-4|v| + 1e-6): values and Jacobians equal
  the reference's to the last bit;
* the value's ``jvp`` is J[:, :nx] dx + J[:, nx:] du, ignoring the t
  tangent (time is a stage-grid constant; free-final-time problems scale
  time through an extra state), and its ``backward`` is J' g;
* a second derivative needs the Jacobian's own derivative, which the host
  does not give: it raises, naming the model, where the reference raises
  "Pure callbacks do not support JVP" (an exact Hessian through a hosted
  model, e.g. the Gerschgorin hela, fails in both packages).
"""

from __future__ import annotations

import numpy as np
import torch

from hqp_tpu_torch.omu.model import Model
from hqp_tpu_torch.utils import sync


def _fd_jacobian(fn, t, x, u, m):
    """Central-difference Jacobian [m, nx+nu] of fn(t, x, u) on host."""
    v = np.concatenate([x, u])
    nx = x.shape[0]
    J = np.zeros((m, v.shape[0]))
    for j in range(v.shape[0]):
        dv = 1e-4 * abs(v[j]) + 1e-6
        vp = v.copy()
        vm = v.copy()
        vp[j] += dv
        vm[j] -= dv
        J[:, j] = (np.asarray(fn(t, vp[:nx], vp[nx:]))
                   - np.asarray(fn(t, vm[:nx], vm[nx:]))) / (2 * dv)
    return J


class _HostFn:
    """One host function of a hosted model: ``fn(t, x, u)`` with ``m``
    outputs, and its Jacobian (the evaluator's ``jac`` or finite
    differences), each evaluated over a batch of stages."""

    def __init__(self, model, fn, m, jac):
        self.model, self.fn, self.m, self.jac = model, fn, m, jac

    def value(self, t, x, u):
        return np.asarray(self.fn(float(t), np.asarray(x, np.float64),
                                  np.asarray(u, np.float64)), np.float64)

    def jacobian(self, t, x, u):
        t = float(t)
        x = np.asarray(x, np.float64)
        u = np.asarray(u, np.float64)
        J = self.jac(t, x, u) if self.jac is not None else None
        if J is None:
            J = _fd_jacobian(self.value, t, x, u, self.m)
        return np.asarray(J, np.float64)

    def run(self, host, t, x, u, shape):
        """host(t_b, x_b, u_b) for every stage b of the leading axes: one
        counted copy of the batch to the host, one copy back."""
        nx, nu = self.model.nx, self.model.nu
        lead = x.shape[:-1]
        pack = torch.cat([torch.broadcast_to(t, lead).reshape(-1, 1),
                          x.reshape(-1, nx), u.reshape(-1, nu)], dim=1)
        a = self.model._d2h(pack)
        out = np.stack([host(r[0], r[1:1 + nx], r[1 + nx:]) for r in a])
        return self.model._h2d(out, x.device).reshape(*lead, *shape)

    def no_second(self):
        return RuntimeError(
            f"hosted model {self.model.name!r}: no second derivative (the "
            "host gives values and Jacobians only; the JAX package raises "
            "'Pure callbacks do not support JVP' here)")


def _batch_first(info, in_dims, *args):
    """The inputs with their vmap axis first (unbatched ones expanded)."""
    return [a.expand(info.batch_size, *a.shape) if d is None
            else a.movedim(d, 0) for a, d in zip(args, in_dims)]


def _mv(J, d):
    return torch.einsum("...ij,...j->...i", J, d)


class _HostValue(torch.autograd.Function):
    """y = fn(t, x, u) of a :class:`_HostFn`, on any leading axes."""

    @staticmethod
    def forward(h, t, x, u):
        return h.run(h.value, t, x, u, (h.m,))

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, t, x, u = inputs
        ctx.h = h
        ctx.save_for_forward(t, x, u)
        ctx.save_for_backward(t, x, u)

    @staticmethod
    def jvp(ctx, _h_t, _t_t, dx, du):
        t, x, u = ctx.saved_tensors
        J = _HostJacobian.apply(ctx.h, t, x, u)
        nx = x.shape[-1]
        dy = torch.zeros_like(J[..., 0])
        if dx is not None:
            dy = dy + _mv(J[..., :nx], dx)
        if du is not None:
            dy = dy + _mv(J[..., nx:], du)
        return dy

    @staticmethod
    def backward(ctx, g):
        t, x, u = ctx.saved_tensors
        J = _HostJacobian.apply(ctx.h, t, x, u)
        gv = torch.einsum("...i,...ij->...j", g, J)
        nx = x.shape[-1]
        return None, None, gv[..., :nx], gv[..., nx:]

    @staticmethod
    def vmap(info, in_dims, h, t, x, u):
        return _HostValue.apply(h, *_batch_first(info, in_dims[1:],
                                                 t, x, u)), 0


class _HostJacobian(torch.autograd.Function):
    """J = [dfdx | dfdu] [m, nx+nu] of a :class:`_HostFn`; it has no
    derivative of its own."""

    @staticmethod
    def forward(h, t, x, u):
        return h.run(h.jacobian, t, x, u,
                     (h.m, h.model.nx + h.model.nu))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.h = inputs[0]

    @staticmethod
    def jvp(ctx, *tangents):
        raise ctx.h.no_second()

    @staticmethod
    def backward(ctx, g):
        raise ctx.h.no_second()

    @staticmethod
    def vmap(info, in_dims, h, t, x, u):
        return _HostJacobian.apply(h, *_batch_first(info, in_dims[1:],
                                                    t, x, u)), 0


class HostedModel(Model):
    """Model protocol over an hxi evaluator.

    Continuous models (evaluator.nx > 0) provide ``ode``; discrete models
    (nxd > 0) provide ``dt_update``.  Parameters are bound at evaluator
    construction (S-function parameters / FMU start values), so
    ``npar = 0`` from the optimizer's point of view.
    """

    def __init__(self, evaluator):
        self.ev = evaluator
        self.name = getattr(evaluator, "name", type(evaluator).__name__)
        self.discrete = evaluator.nx == 0 and evaluator.nxd > 0
        self.nx = evaluator.nxd if self.discrete else evaluator.nx
        self.nu = evaluator.nu
        self.ny = evaluator.ny
        self.npar = 0
        self.p0 = ()
        #: bytes copied device -> host and host -> device
        self.moved = {"d2h": 0, "h2d": 0}

        jac = getattr(evaluator, "jacobian", None)
        if self.discrete:
            self._upd = _HostFn(self, evaluator.update, self.nx, None)
        else:
            self._ode = _HostFn(self, evaluator.derivatives, self.nx, jac)
        self._out = _HostFn(self, evaluator.outputs, self.ny, None)

    def _d2h(self, t):
        self.moved["d2h"] += t.numel() * t.element_size()
        return sync.to_host(t)

    def _h2d(self, a, device):
        self.moved["h2d"] += a.nbytes
        return torch.from_numpy(a).to(device)

    @staticmethod
    def _call(h, t, x, u):
        if not torch.is_tensor(t):
            t = torch.as_tensor(t, dtype=torch.float64, device=x.device)
        return _HostValue.apply(h, t, x, u)

    # -- Model protocol --------------------------------------------------------
    def ode(self, t, x, u, p):
        if self.discrete:
            raise TypeError("discrete hosted model has no ODE; use DTOpt")
        return self._call(self._ode, t, x, u)

    def outputs(self, t, x, u, p):
        return self._call(self._out, t, x, u)

    def dt_update(self, t, x, u, p):
        """Discrete-time state update x+ = f(t, x, u) (mdlUpdate role)."""
        if not self.discrete:
            raise TypeError("continuous hosted model has no dt_update")
        return self._call(self._upd, t, x, u)

    def default_p(self, device="cuda"):
        return torch.zeros((0,), dtype=torch.float64, device=device)

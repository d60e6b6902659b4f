"""QP intermediate representations.

Port of ``hqp_tpu/qp/program.py``.  Two IRs replace the reference's
general sparse ``Hqp_Program`` (hqp/Hqp_Program.h:33-65):

* :class:`StageQP` -- the stage-structured (DOCP) QP: per-stage blocks
  live as ``[K, n, n]`` tensors, variable bounds are diagonal box
  constraints, and padding is carried as masks;
* :class:`DenseQP` -- a dense general QP in the reference's own form
  (min 1/2 x'Qx + c'x s.t. Ax + b = 0, Cx + d >= 0) for programs without
  stage structure (the NLP suite and the generated families).

Both offer the protocol the interior point consumes: matvecs, one-sided
inequality values as a dataclass of groups, masks and data norms.

A StageQP may carry leading batch axes on every field (a scenario batch,
``Q [B, K1, nv, nv]``, ...): the shape properties read trailing axes,
``nb`` counts the batch axes, and the matvecs and data norm act per
problem.  StageQP and IneqGroups are registered with torch's pytree
utilities, so ``torch.func.vmap`` can return them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree

from hqp_tpu_torch.utils import masked as mk


@dataclasses.dataclass
class IneqGroups:
    """The four one-sided inequality groups of a StageQP.

    box lower (v - lb >= 0), box upper (ub - v >= 0),
    general lower (Cv - d_lo >= 0), general upper (d_up - Cv >= 0).
    Used for constraint values, slacks w, multipliers z, masks, ...
    """

    bl: torch.Tensor  # [K1, nv]
    bu: torch.Tensor  # [K1, nv]
    gl: torch.Tensor  # [K1, mc]
    gu: torch.Tensor  # [K1, mc]


@dataclasses.dataclass
class StageQP:
    """Stage-structured QP over variables v_k = (x_k, u_k), k = 0..K.

    minimize    sum_k 1/2 v_k' Q_k v_k + c_k' v_k
    subject to  A_k v_k - x_{k+1} + b_k = 0        k = 0..K-1   (dynamics)
                E_k v_k + e_k = 0                                (stage equality)
                lb_k <= v_k <= ub_k                              (box)
                d_lo_k <= C_k v_k <= d_up_k                      (general)

    Shapes: K1 = K + 1 stages, nv = nx + nu padded variables per stage.
    Stage K's u-components are padding (var_mask False).  Infinite bounds
    mark absent constraints; E = None means no stage equality rows.
    """

    Q: torch.Tensor      # [K1, nv, nv]
    c: torch.Tensor      # [K1, nv]
    A: torch.Tensor      # [K, nx, nv]
    b: torch.Tensor      # [K, nx]
    lb: torch.Tensor     # [K1, nv]
    ub: torch.Tensor     # [K1, nv]
    C: torch.Tensor      # [K1, mc, nv]
    d_lo: torch.Tensor   # [K1, mc]
    d_up: torch.Tensor   # [K1, mc]
    var_mask: torch.Tensor  # [K1, nv] bool
    con_mask: torch.Tensor  # [K1, mc] bool
    E: torch.Tensor | None = None         # [K1, meq, nv]
    e: torch.Tensor | None = None         # [K1, meq]
    eqg_mask: torch.Tensor | None = None  # [K1, meq] bool

    # ---- static shape info -------------------------------------------------
    @property
    def K(self) -> int:
        return self.A.shape[-3]

    @property
    def nx(self) -> int:
        return self.A.shape[-2]

    @property
    def nv(self) -> int:
        return self.A.shape[-1]

    @property
    def nu(self) -> int:
        return self.nv - self.nx

    @property
    def mc(self) -> int:
        return self.C.shape[-2]

    @property
    def meq(self) -> int:
        return 0 if self.E is None else self.E.shape[-2]

    @property
    def nb(self) -> int:
        """Number of leading batch axes (0 for one problem)."""
        return self.A.dim() - 3

    @property
    def batch_shape(self) -> torch.Size:
        return self.A.shape[:-3]

    @property
    def device(self) -> torch.device:
        return self.c.device

    def has_gen_eq(self) -> bool:
        """Static: does the program carry general stage equality rows?"""
        return self.E is not None and self.E.shape[-2] > 0

    # ---- masks -------------------------------------------------------------
    def fixed_mask(self) -> torch.Tensor:
        """Variables with lb == ub: equality rows (hqp/Hqp_Docp.C:372)."""
        return (torch.isfinite(self.lb) & torch.isfinite(self.ub)
                & (self.lb == self.ub) & self.var_mask)

    def fixed_val(self) -> torch.Tensor:
        return torch.where(self.fixed_mask(), _z(self.lb), 0.0)

    def ineq_mask(self) -> IneqGroups:
        fix = self.fixed_mask()
        return IneqGroups(
            bl=torch.isfinite(self.lb) & self.var_mask & ~fix,
            bu=torch.isfinite(self.ub) & self.var_mask & ~fix,
            gl=torch.isfinite(self.d_lo) & self.con_mask,
            gu=torch.isfinite(self.d_up) & self.con_mask,
        )

    def eq_mask(self):
        out = {"dyn": torch.ones_like(self.b, dtype=torch.bool),
               "fix": self.fixed_mask()}
        if self.has_gen_eq():
            out["gen"] = self.eqg_mask
        return out

    def x_mask(self) -> torch.Tensor:
        """Mask of structurally present variables."""
        return self.var_mask

    def A_masked(self):
        """Dynamics Jacobian with absent-variable columns zeroed."""
        return self.A * self.var_mask[..., :-1, None, :]

    def xcoupling_mask(self):
        """Mask of the -I next-state coupling (x-part of stages 1..K)."""
        return self.var_mask[..., 1:, : self.nx]

    # ---- linear algebra ----------------------------------------------------
    def matvec_Q(self, v):
        return torch.einsum("...kij,...kj->...ki", self.Q, v)

    def eval_eq(self, v):
        """Equality groups in 'Ax + b' form: dynamics, fixed variables and
        general stage rows."""
        Av = torch.einsum("...kij,...kj->...ki", self.A, v[..., :-1, :])
        fix = self.fixed_mask()
        out = {"dyn": Av - v[..., 1:, : self.nx] + self.b,
               "fix": torch.where(fix, v - self.fixed_val(), 0.0)}
        if self.has_gen_eq():
            Ev = torch.einsum("...kij,...kj->...ki", self.E, v)
            out["gen"] = torch.where(self.eqg_mask, Ev + self.e, 0.0)
        return out

    def matvec_eqT(self, y):
        """Adjoint of eval_eq's linear part into variable space [K1, nv]."""
        yd = y["dyn"]
        out = torch.zeros_like(self.c)
        out[..., :-1, :] += torch.einsum("...kij,...ki->...kj", self.A, yd)
        out[..., 1:, : self.nx] -= yd
        out = out + torch.where(self.fixed_mask(), y["fix"], 0.0)
        if self.has_gen_eq():
            yg = torch.where(self.eqg_mask, y["gen"], 0.0)
            out = out + torch.einsum("...kij,...ki->...kj", self.E, yg)
        return out

    def matvec_ineq(self, v) -> IneqGroups:
        Cv = torch.einsum("...kij,...kj->...ki", self.C, v)
        return IneqGroups(bl=v, bu=-v, gl=Cv, gu=-Cv)

    def matvec_ineqT(self, z: IneqGroups):
        # mask out the sentinel values the IP keeps in invalid entries
        m = self.ineq_mask()
        zbl = torch.where(m.bl, z.bl, 0.0)
        zbu = torch.where(m.bu, z.bu, 0.0)
        zg = torch.where(m.gl, z.gl, 0.0) - torch.where(m.gu, z.gu, 0.0)
        return (zbl - zbu) + torch.einsum("...kij,...ki->...kj", self.C, zg)

    def eval_ineq(self, v) -> IneqGroups:
        """One-sided constraint values 'Cv + d' per group (>= 0 feasible)."""
        Cv = torch.einsum("...kij,...kj->...ki", self.C, v)
        return IneqGroups(
            bl=v - _z(self.lb), bu=_z(self.ub) - v,
            gl=Cv - _z(self.d_lo), gu=_z(self.d_up) - Cv,
        )

    def ineq_offsets(self) -> IneqGroups:
        """One-sided 'd' offsets (for the duality gap z'd term)."""
        return IneqGroups(bl=-_z(self.lb), bu=_z(self.ub),
                          gl=-_z(self.d_lo), gu=_z(self.d_up))

    def eq_offsets(self):
        out = {"dyn": self.b,
               "fix": torch.where(self.fixed_mask(), -self.fixed_val(), 0.0)}
        if self.has_gen_eq():
            out["gen"] = torch.where(self.eqg_mask, self.e, 0.0)
        return out

    def norm_data(self):
        """max of the infinity norms of Q, A, C, c, b, d (masked); the
        relative-termination scale of hqp/Hqp_IpsMehrotra.C:459-461; one
        per problem of a batch."""
        im = self.ineq_mask()
        nb = self.nb
        terms = [mk.amax_all(self.Q.abs(), nb)]
        if self.A.numel():
            terms.append(mk.amax_all(self.A.abs(), nb))
        if self.C.numel():
            terms.append(mk.amax_all(self.C.abs(), nb))
        terms += [
            mk.norm_inf(self.c, self.var_mask, nb),
            mk.norm_inf(self.fixed_val(), self.fixed_mask(), nb),
            mk.norm_inf(_z(self.lb), im.bl, nb),
            mk.norm_inf(_z(self.ub), im.bu, nb),
            mk.norm_inf(_z(self.d_lo), im.gl, nb),
            mk.norm_inf(_z(self.d_up), im.gu, nb),
        ]
        if self.b.numel():
            terms.append(mk.norm_inf(self.b, nb=nb))
        if self.has_gen_eq():
            terms.append(mk.amax_all(
                (self.E * self.eqg_mask[..., None]).abs(), nb))
            terms.append(mk.norm_inf(self.e, self.eqg_mask, nb))
        top = torch.stack(terms).amax() if nb == 0 else \
            torch.stack(terms, dim=-1).amax(-1)
        return torch.clamp(top, min=1e-10)

    def zero_x(self):
        return torch.zeros_like(self.c)


def _z(a):
    """Replace +-inf by 0 (masked-out offsets must stay finite)."""
    return torch.where(torch.isfinite(a), a, 0.0)


def _register_pytree(cls):
    """Register a dataclass of tensors (fields may be None) as a torch
    pytree node: the present fields are its children."""
    names = [fl.name for fl in dataclasses.fields(cls)]

    def flatten(obj):
        have = tuple(n for n in names if getattr(obj, n) is not None)
        return [getattr(obj, n) for n in have], have

    def unflatten(values, have):
        return cls(**dict(zip(have, values)))

    pytree.register_pytree_node(
        cls, flatten, unflatten,
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}")


_register_pytree(IneqGroups)
_register_pytree(StageQP)


@dataclasses.dataclass
class DenseIneq:
    """The single inequality group of a DenseQP (one-sided, Cx + d >= 0)."""

    g: torch.Tensor  # [mi]


@dataclasses.dataclass
class DenseQP:
    """Dense general QP in the reference's notation (hqp/Hqp_Program.h):

    minimize    1/2 x'Qx + c'x
    subject to  Ax + b  = 0
                Cx + d >= 0

    Rows may be padding, marked by eq_mask_ / ineq_mask_.
    """

    Q: torch.Tensor          # [n, n]
    c: torch.Tensor          # [n]
    A: torch.Tensor          # [me, n]
    b: torch.Tensor          # [me]
    C: torch.Tensor          # [mi, n]
    d: torch.Tensor          # [mi]
    eq_mask_: torch.Tensor    # [me] bool
    ineq_mask_: torch.Tensor  # [mi] bool

    #: a DenseQP is one problem: no batch axes
    nb = 0

    @property
    def n(self) -> int:
        return self.Q.shape[0]

    @property
    def me(self) -> int:
        return self.A.shape[0]

    @property
    def mi(self) -> int:
        return self.C.shape[0]

    @property
    def device(self) -> torch.device:
        return self.c.device

    @staticmethod
    def build(Q, c, A=None, b=None, C=None, d=None):
        """A DenseQP from tensors on one device, every row present; absent
        row groups become empty."""
        f = dict(dtype=torch.float64, device=Q.device)
        n = Q.shape[0]
        A = torch.zeros((0, n), **f) if A is None else A.to(**f)
        b = torch.zeros((0,), **f) if b is None else b.to(**f)
        C = torch.zeros((0, n), **f) if C is None else C.to(**f)
        d = torch.zeros((0,), **f) if d is None else d.to(**f)
        return DenseQP(
            Q=Q.to(**f), c=c.to(**f), A=A, b=b, C=C, d=d,
            eq_mask_=torch.ones(A.shape[0], dtype=torch.bool,
                                device=Q.device),
            ineq_mask_=torch.ones(C.shape[0], dtype=torch.bool,
                                  device=Q.device))

    def x_mask(self):
        return torch.ones_like(self.c, dtype=torch.bool)

    def ineq_mask(self) -> DenseIneq:
        return DenseIneq(g=self.ineq_mask_)

    def eq_mask(self):
        return self.eq_mask_

    def matvec_Q(self, x):
        return self.Q @ x

    def eval_eq(self, x):
        return self.A @ x + self.b

    def matvec_eqT(self, y):
        return self.A.T @ torch.where(self.eq_mask_, y, 0.0)

    def matvec_ineq(self, x) -> DenseIneq:
        return DenseIneq(g=self.C @ x)

    def matvec_ineqT(self, z: DenseIneq):
        return self.C.T @ torch.where(self.ineq_mask_, z.g, 0.0)

    def eval_ineq(self, x) -> DenseIneq:
        return DenseIneq(g=self.C @ x + self.d)

    def ineq_offsets(self) -> DenseIneq:
        return DenseIneq(g=self.d)

    def eq_offsets(self):
        return self.b

    def norm_data(self):
        """max of the infinity norms of Q, A, C, c, b, d (masked)."""
        terms = [mk.norm_inf(self.c)]
        for a in (self.Q, self.A, self.C):
            if a.numel():
                terms.append(a.abs().amax())
        if self.b.numel():
            terms.append(mk.norm_inf(self.b, self.eq_mask_))
        if self.d.numel():
            terms.append(mk.norm_inf(self.d, self.ineq_mask_))
        return torch.clamp(torch.stack(terms).amax(), min=1e-10)

    def zero_x(self):
        return torch.zeros_like(self.c)

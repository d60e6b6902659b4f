"""Partitioned Schur-complement KKT backend ("SpSC").

Port of ``hqp_tpu/qp/kkt_partitioned.py``.  The horizon splits into P
partitions of L stages; the interior variables of every partition are
eliminated in parallel through one batched pivoted Gauss-Jordan inverse
(kernel K1, :mod:`hqp_tpu_torch.ops.gj_cuda`), leaving an SPD
block-tridiagonal master system in the P+1 boundary states, solved by the
block-Thomas kernel K2 (:mod:`hqp_tpu_torch.ops.thomas_cuda`) with
refinement, or by cyclic reduction with ``master="cr"``.

Routing is by the instance's factor dtype, never by backend: the kernels
run at float64 by default (Hopper has native f64) and at float32 with
``factor_dtype="f32"``, each with the refinement defaults the reference
uses for that dtype.  On CPU tensors the kernel wrappers run their plain
twins, so the same code path is what the CPU tests exercise.

Structurally absent variables (x_mask False) get identity rows;
dynamically fixed variables (lb == ub) are pinned by a large diagonal
penalty with multipliers recovered from stationarity, made exact by
refinement (hqp/Hqp_IpSpSC.C's role, with the stage-parallel split of
SURVEY.md section 2.7.3).

A batch of QPs (leading batch axes on every field, a scenario batch) is
factored and solved at once: the B*P interiors of the whole batch go
through ONE K1 launch per factorization, flattened to [B*P, s, s], and
the B masters through one K2 launch per master solve on [B, P+1, nx, nx].

Spans (:mod:`hqp_tpu_torch.utils.log`): ``partitioned.factor`` with its
children ``partitioned.interior`` (Ruiz scaling, K1 and the inner-refined
couplings) and ``partitioned.master`` (the master's assembly and
equilibration); ``partitioned.solve`` with a ``partitioned.reduced`` a
reduced solve and the refinement's ``kkt.refine``.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from hqp_tpu_torch.ops import blocktri, gj_cuda, thomas_cuda
from hqp_tpu_torch.ops import smalllin as sl
from hqp_tpu_torch.qp import kkt as K_
from hqp_tpu_torch.qp.program import StageQP
from hqp_tpu_torch.utils import log
from hqp_tpu_torch.utils.registry import modules


@dataclasses.dataclass
class PartFactors:
    Minv: torch.Tensor    # [B*P, s, s] inverse of the SCALED interior
    Dscale: torch.Tensor  # [B*P, s] Ruiz scaling: MII^-1 ~= D Minv D
    MII: torch.Tensor     # [B*P, s, s] SCALED interior (f64)
    W: torch.Tensor       # [B*P, s, 2nx] M_II^-1 M_IB (inner-refined)
    MIB: torch.Tensor     # [B*P, s, 2nx]
    master: tuple         # ("thomas", Sm, Um, Sm_k, Um_k) | ("cr", factors)
    dM: torch.Tensor      # [B, P+1, nx] Jacobi scaling of the master
    LuuK: torch.Tensor    # [B, nu, nu] terminal u-block Cholesky
    KgainK: torch.Tensor  # [B, nu, nx]
    # (the interiors of all problems of a batch flattened into one axis;
    # no B axis for one problem)


def _interior_dim(L, nx, nu):
    nv = nx + nu
    return nu + (L - 1) * nv + L * nx


def _interior_apply(fac0, rho, inner):
    """MII^-1 rho to f64 accuracy: scaled factor inverse plus ``inner``
    refinement rounds carried entirely in the Ruiz-scaled space (the raw
    interior mixes 1e10 penalty rows with 1e-8 regularization rows; after
    equilibration the refinement touches only unit-scaled quantities).
    rho: [P, s] or [P, s, m] (P: every interior of a batch)."""
    Minv, Dd, MII_s = fac0
    vec = rho.dim() == 2
    if vec:
        rho = rho[..., None]
    Ddc = Dd[:, :, None]
    rho_s = Ddc * rho

    def apply_inv(r_s):
        return (Minv @ r_s.to(Minv.dtype)).to(rho.dtype)

    t = apply_inv(rho_s)
    for _ in range(inner):
        t = t + apply_inv(rho_s - MII_s @ t)
    t = Ddc * t
    return t[..., 0] if vec else t


def _master_matvec(Sm, Um, x):
    """Equilibrated master block-tridiagonal matvec (f64); the stage axis
    is -2 of x, behind any batch axes."""
    y = torch.einsum("...pij,...pj->...pi", Sm, x)
    y[..., :-1, :] += torch.einsum("...pij,...pj->...pi", Um, x[..., 1:, :])
    y[..., 1:, :] += torch.einsum("...pji,...pj->...pi", Um, x[..., :-1, :])
    return y


def _master_solve(master, dM, rhs, inner):
    """Master solve: cyclic reduction (exact, f64), or the block-Thomas
    kernel at the factor dtype plus ``inner`` refinement rounds against
    the f64 master."""
    if master[0] == "cr":
        return blocktri.cr_solve_scaled(master[1], dM, rhs)
    _, Sm, Um, Sk, Uk = master
    r = dM * rhs

    def thomas(b):
        return thomas_cuda.thomas_solve(Sk, Uk, b.to(Sk.dtype)).to(r.dtype)

    x = thomas(r)
    for _ in range(inner):
        x = x + thomas(r - _master_matvec(Sm, Um, x))
    return dM * x


class PartitionedKKT:
    """Stage-partitioned Schur-complement factorization of a StageQP KKT.

    ``factor_dtype``: "f64" (default) or "f32", the dtype of the interior
    inverse and of the Thomas master.  ``master``: None or "thomas" for
    the K2 kernel (blocks up to ``thomas_cuda.MAX_BLOCK``), "cr" for f64
    cyclic reduction.  The other keywords are the reference's, with its
    meaning; None resolves by the factor dtype as the reference's defaults
    do (f64 / f32):

    - ``refine_eps`` (1e-10 / 3e-7) and ``refine_rounds`` (4 / 2): the
      true-residual refinement gate of every solve (:func:`kkt.refine`);
      ``refine_relative`` scales ``refine_eps`` by the rhs norm (True) or
      takes it as an absolute bound (False);
    - ``dual_reg`` (1e-8 / 3e-7): the +delta I on the interior dynamics
      rows, and ``reg_corr_rounds`` (2): its analytic corrections per
      solve;
    - ``gj``: None or any value but "xla" inverts the interiors by kernel
      K1 (its routes by size, :func:`gj_cuda.route`); "xla" is the
      caller's request for the library inverse ``torch.linalg.inv``, with
      which K1 is not launched.  The inner rounds (1 / 4) also refine the
      master, per instance."""

    def __init__(self, L: int = 16, refine_eps: float | None = None,
                 refine_rounds: int | None = None,
                 dual_reg: float | None = None,
                 reg_corr_rounds: int | None = None,
                 master: str | None = None, gj: str | None = None,
                 refine_relative: bool = True,
                 factor_dtype: str | None = None):
        if factor_dtype not in (None, "f64", "f32"):
            raise ValueError(f"factor_dtype {factor_dtype!r}: need f64/f32")
        if master not in (None, "thomas", "cr"):
            raise ValueError(f"master {master!r}: need thomas/cr")
        self.L = L
        self.refine_eps = refine_eps
        self.refine_rounds = refine_rounds
        self.dual_reg = dual_reg
        self.reg_corr_rounds = 2 if reg_corr_rounds is None \
            else reg_corr_rounds
        self.master = master
        self.gj = gj
        self.refine_relative = refine_relative
        self.factor_dtype = factor_dtype

    def _config(self):
        return (type(self), self.L, self.refine_eps, self.refine_rounds,
                self.dual_reg, self.reg_corr_rounds, self.master, self.gj,
                self.refine_relative, self.factor_dtype)

    def __hash__(self):
        return hash(self._config())

    def __eq__(self, other):
        return isinstance(other, PartitionedKKT) and \
            self._config() == other._config()

    # -- per-instance resolution by factor dtype ------------------------------

    def _lu(self):
        return torch.float32 if self.factor_dtype == "f32" else torch.float64

    def _inner(self):
        return 4 if self._lu() == torch.float32 else 1

    def _master_k(self):
        return self.master or "thomas"

    def _refine_eps(self):
        if self.refine_eps is not None:
            return self.refine_eps
        return 3e-7 if self._lu() == torch.float32 else 1e-10

    def _refine_rounds(self):
        if self.refine_rounds is not None:
            return self.refine_rounds
        return 2 if self._lu() == torch.float32 else 4

    def with_refine(self, rounds: int):
        """A copy whose solves take ``rounds`` refinement rounds (the same
        factor layout, so it consumes this instance's factorizations): the
        IP solver's cheap predictor, which only shapes sigma and the
        corrector's right-hand side, skips the true-residual gate that the
        accepted direction pays."""
        if rounds == self.refine_rounds:
            return self
        new = copy.copy(self)
        new.refine_rounds = rounds
        return new

    def _dual_reg(self):
        if self.dual_reg is not None:
            return self.dual_reg
        return 3e-7 if self._lu() == torch.float32 else 1e-8

    def _choose_L(self, K, nx, nu):
        """A divisor of K close to the requested L, at least ceil(nx/nu)+1
        (below that the interior saddle is structurally singular)."""
        Lmin = max(2, -(-nx // max(nu, 1)) + 1)
        for L in range(min(self.L, K), 0, -1):
            if K % L == 0 and L >= Lmin:
                return L
        for L in range(min(self.L, K) + 1, K + 1):
            if K % L == 0 and L >= Lmin:
                return L
        return K

    def _layout(self, qp: StageQP):
        """Static partition layout: (L, P, interior size, offsets).
        Interior order: [u_{pL} | v_{pL+1..pL+L-1} | y_{pL..pL+L-1}]."""
        nx, nu, nv = qp.nx, qp.nu, qp.nv
        L = self._choose_L(qp.K, nx, nu)
        P = qp.K // L
        s = _interior_dim(L, nx, nu)
        return L, P, s, (0, nu, nu + (L - 1) * nv)

    def _dims(self, qp: StageQP):
        L, P, s, offs = self._layout(qp)
        return L, P, (L, s, qp.nx, qp.nu, qp.nv, offs)

    @staticmethod
    def _coupling_masks(qp: StageQP, L, P):
        """Masks for the -I couplings: interior states [B*P, L-1, nx] and
        partition-end boundary states [B*P, nx], the partitions of a batch
        flattened."""
        xs = qp.var_mask[..., : qp.nx].to(qp.A.dtype)   # [K1, nx]
        BP = xs[..., 0, 0].numel() * P
        mm_int = xs[..., : qp.K, :].reshape(BP, L, qp.nx)[:, 1:]
        mm_e = xs[..., L::L, :].reshape(BP, qp.nx)
        return mm_int, mm_e

    # -- assembly ------------------------------------------------------------

    @staticmethod
    def _assembly_maps(dims):
        """Static numpy gather/scatter maps lowering stage data onto the
        interior saddle MII [s, s] and coupling MIB [s, 2nx] (the same
        maps as the reference)."""
        L, s, nx, nu, nv, (off_u, off_v, off_y) = dims

        def block(rows, cols, src_base, src_shape, sel_r, sel_c, sign, out):
            a, b = np.meshgrid(np.arange(len(sel_r)), np.arange(len(sel_c)),
                               indexing="ij")
            rr = (rows + a).ravel()
            cc = (cols + b).ravel()
            si = (src_base
                  + np.asarray(sel_r, dtype=np.int64)[a.ravel()]
                  * src_shape[-1]
                  + np.asarray(sel_c, dtype=np.int64)[b.ravel()])
            out.append((rr, cc, si, np.full(rr.shape, sign, np.float64)))

        H_ent, A_ent, Hb_ent, Ab_ent = [], [], [], []
        hstage = nv * nv
        astage = nx * nv

        # u-block of stage 0: M[u, u] = -H0[nx:, nx:], B[u, :nx] = -H0[nx:, :nx]
        block(off_u, off_u, 0, (nv, nv), range(nx, nv), range(nx, nv),
              -1.0, H_ent)
        block(off_u, 0, 0, (nv, nv), range(nx, nv), range(nx),
              -1.0, Hb_ent)
        # M[u, y0] = A0[:, nx:].T
        a, b = np.meshgrid(np.arange(nu), np.arange(nx), indexing="ij")
        A_ent.append(((off_u + a).ravel(), (off_y + b).ravel(),
                      (b * nv + nx + a).ravel(), np.ones(nu * nx)))

        for j in range(1, L):
            r = off_v + (j - 1) * nv
            # M[v_j, v_j] = -H[j];  M[v_j, y_j] = A[j].T
            block(r, r, j * hstage, (nv, nv), range(nv), range(nv),
                  -1.0, H_ent)
            a, b = np.meshgrid(np.arange(nv), np.arange(nx), indexing="ij")
            A_ent.append(((r + a).ravel(), (off_y + j * nx + b).ravel(),
                          (j * astage + b * nv + a).ravel(),
                          np.ones(nv * nx)))
        for j in range(L):
            yj = off_y + j * nx
            if j == 0:
                # B[y0, :nx] = A0[:, :nx];  M[y0, u] = A0[:, nx:]
                a, b = np.meshgrid(np.arange(nx), np.arange(nx),
                                   indexing="ij")
                Ab_ent.append(((yj + a).ravel(), b.ravel(),
                               (a * nv + b).ravel(), np.ones(nx * nx)))
                a, b = np.meshgrid(np.arange(nx), np.arange(nu),
                                   indexing="ij")
                A_ent.append(((yj + a).ravel(), (off_u + b).ravel(),
                              (a * nv + nx + b).ravel(), np.ones(nx * nu)))
            else:
                r = off_v + (j - 1) * nv
                a, b = np.meshgrid(np.arange(nx), np.arange(nv),
                                   indexing="ij")
                A_ent.append(((yj + a).ravel(), (r + b).ravel(),
                              (j * astage + a * nv + b).ravel(),
                              np.ones(nx * nv)))

        # interior couplings -diag(mm_int): M[v_j(:nx), y_{j-1}] and
        # M[y_j, v_{j+1}(:nx)]
        mi_rows, mi_cols, mi_src = [], [], []
        for j in range(1, L):
            a = np.arange(nx)
            mi_rows.append(off_v + (j - 1) * nv + a)
            mi_cols.append(off_y + (j - 1) * nx + a)
            mi_src.append((j - 1) * nx + a)
        for j in range(L - 1):
            a = np.arange(nx)
            mi_rows.append(off_y + j * nx + a)
            mi_cols.append(off_v + j * nv + a)
            mi_src.append(j * nx + a)

        # partition-end coupling: B[y_{L-1}, nx:] = -diag(mm_e)
        a = np.arange(nx)
        me_rows = off_y + (L - 1) * nx + a
        me_cols = nx + a

        # dual regularization: constant diagonal on the dynamics rows
        dmask = np.zeros((s, s))
        dmask[off_y + np.arange(L * nx), off_y + np.arange(L * nx)] = 1.0

        def cat(ent):
            return tuple(np.concatenate([e[i] for e in ent])
                         for i in range(4))

        def cati(lst):
            return (np.concatenate(lst).astype(np.int64) if lst
                    else np.zeros(0, np.int64))

        return dict(H=cat(H_ent), A=cat(A_ent), HB=cat(Hb_ent),
                    AB=cat(Ab_ent),
                    MI=(cati(mi_rows), cati(mi_cols), cati(mi_src)),
                    ME=(me_rows.astype(np.int64), me_cols.astype(np.int64)),
                    dmask=dmask)

    #: assembly maps as device tensors, keyed by (dims, device, dtype)
    _maps_cache: dict = {}

    @classmethod
    def _device_maps(cls, dims, device, dtype):
        key = (dims, str(device), dtype)
        maps = cls._maps_cache.get(key)
        if maps is not None:
            return maps
        m = cls._assembly_maps(dims)

        def li(*arrs):
            return torch.as_tensor(np.concatenate(arrs).astype(np.int64),
                                   device=device)

        def fl(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        hr, hc, hs_, hg = m["H"]
        ar, ac, as_, ag = m["A"]
        mir, mic, mis = m["MI"]
        br, bc, bs_, bg = m["HB"]
        abr, abc, abs_, abg = m["AB"]
        mer, mec = m["ME"]
        maps = dict(
            rows=li(hr, ar, mir), cols=li(hc, ac, mic),
            h_src=li(hs_), h_sgn=fl(hg), a_src=li(as_), a_sgn=fl(ag),
            mi_src=li(mis),
            rowsB=li(br, abr, mer), colsB=li(bc, abc, mec),
            hb_src=li(bs_), hb_sgn=fl(bg), ab_src=li(abs_), ab_sgn=fl(abg),
            dmask=fl(m["dmask"]))
        cls._maps_cache[key] = maps
        return maps

    @classmethod
    def _partition_blocks(cls, Hs, As, mm_int, mm_e, dims, dual_reg):
        """Per-partition interior saddle blocks MII and boundary couplings
        MIB: one gather and one scatter-add (index_put_ with accumulate)
        per target, with static maps cached on the device.  The partitions
        of a batch come flattened into the leading axis."""
        L, s, nx, nu, nv, offs = dims
        mp = cls._device_maps(dims, Hs.device, Hs.dtype)
        P = Hs.shape[0]
        Hf = Hs.reshape(P, -1)
        Af = As.reshape(P, -1)
        mif = mm_int.reshape(P, -1)
        pidx = torch.arange(P, device=Hs.device)[:, None]

        vals = torch.cat([Hf[:, mp["h_src"]] * mp["h_sgn"],
                          Af[:, mp["a_src"]] * mp["a_sgn"],
                          -mif[:, mp["mi_src"]]], dim=1)
        MII = (mp["dmask"] * dual_reg).expand(P, s, s).clone()
        MII.index_put_((pidx, mp["rows"], mp["cols"]), vals,
                       accumulate=True)

        valsB = torch.cat([Hf[:, mp["hb_src"]] * mp["hb_sgn"],
                           Af[:, mp["ab_src"]] * mp["ab_sgn"],
                           -mm_e], dim=1)
        MIB = torch.zeros((P, s, 2 * nx), dtype=MII.dtype, device=MII.device)
        MIB.index_put_((pidx, mp["rowsB"], mp["colsB"]), valsB,
                       accumulate=True)
        return MII, MIB

    def _split_stage_data(self, qp: StageQP, H, L, P):
        """Per-partition stage data [B*P, L, ...] (the partitions of a
        batch flattened) plus the boundary [B, P+1, ...] and terminal
        [B, ...] blocks."""
        nv, nx = qp.nv, qp.nx
        Hs = H[..., :-1, :, :].reshape(-1, L, nv, nv)
        As = qp.A_masked().reshape(-1, L, nx, nv)
        mm_int, mm_e = self._coupling_masks(qp, L, P)
        Hb = H[..., ::L, :nx, :nx]               # [P+1, nx, nx] boundary
        return Hs, As, mm_int, mm_e, Hb, H[..., -1, :, :]

    @log.spanned("partitioned.interior")
    def _interior_factor(self, MII, MIB):
        """Ruiz-equilibrated interior inverse (kernel K1 at the factor
        dtype) + inner-refined couplings W.  Returns (Minv, Dd, MII_s, W).

        Symmetric Ruiz equilibration in f64 first: the interiors mix the
        1e-8 dual regularization, O(1) Jacobians and 1e10 penalties, and
        row-max scaling drives every row/column to unit norm (diagonal
        Jacobi scaling fails: the dual rows have near-zero diagonals).
        MII: [B*P, s, s], every interior of a batch: one K1 launch."""
        Dd = torch.ones(MII.shape[:2], dtype=MII.dtype, device=MII.device)
        MII_s = MII
        for _ in range(3):
            rmax = MII_s.abs().amax(dim=2)
            di = 1.0 / torch.sqrt(torch.clamp(rmax, min=1e-12))
            Dd = Dd * di
            MII_s = MII_s * di[:, :, None] * di[:, None, :]
        MIB_s = MIB * Dd[:, :, None]
        lu = self._lu()
        if self.gj == "xla":
            # the caller's choice of the library inverse (the reference's
            # jnp.linalg.inv at the factor dtype): K1 is not launched
            Minv = torch.linalg.inv(MII_s.to(lu))
        else:
            # the kernel also returns the fused W and Schur of the scaled
            # system; like the reference, the path keeps only Minv and
            # forms W with f64 inner refinement (and Schur in f64 from it)
            Minv, _, _ = gj_cuda.interior_factor(MII_s.to(lu).contiguous(),
                                                 MIB_s.to(lu).contiguous())
        fac0 = (Minv, Dd, MII_s)
        W = _interior_apply(fac0, MIB, self._inner())
        return Minv, Dd, MII_s, W

    @staticmethod
    def _terminal(HK, nx):
        """Terminal stage u-elimination."""
        LuuK = sl.chol(HK[..., nx:, nx:])
        KgainK = sl.cho_solve(LuuK, HK[..., nx:, :nx])
        PKxx = HK[..., :nx, :nx] - HK[..., :nx, nx:] @ KgainK
        return LuuK, KgainK, PKxx

    @log.spanned("partitioned.master")
    def _master_build(self, Schur, Hb, PKxx, nx):
        """Assemble and factor the boundary master block-tridiagonal
        system from the per-partition Schur blocks ([B, P, 2nx, 2nx] for a
        batch: B masters, one K2 system each)."""
        D = -Hb
        D[..., -1, :, :] = -PKxx
        D[..., :-1, :, :] += Schur[..., :nx, :nx]
        D[..., 1:, :, :] += Schur[..., nx:, nx:]
        Off = Schur[..., :nx, nx:]               # couples x_p to x_{p+1}
        Sm, Um, dM = blocktri.equilibrate(-D, -Off)
        if self._master_k() == "thomas" and nx <= thomas_cuda.MAX_BLOCK:
            lu = self._lu()
            master = ("thomas", Sm, Um, Sm.to(lu).contiguous(),
                      Um.to(lu).contiguous())
        else:
            master = ("cr", blocktri.cr_factor(Sm, Um))
        return master, dM

    @staticmethod
    def _hess(qp: StageQP, z, w, mask):
        """Reduced stage Hessians with the fixed-variable and general
        stage-equality penalty blocks."""
        return K_._stage_hessians(qp, z, w, mask) + K_.stage_eq_penalty(qp)

    @log.spanned("partitioned.factor")
    def factor(self, qp: StageQP, z, w, mask):
        nx = qp.nx
        H = self._hess(qp, z, w, mask)
        L, P, dims = self._dims(qp)
        Hs, As, mm_int, mm_e, Hb, HK = self._split_stage_data(qp, H, L, P)
        MII, MIB = self._partition_blocks(Hs, As, mm_int, mm_e, dims,
                                          self._dual_reg())
        Minv, Dd, MII_s, W = self._interior_factor(MII, MIB)
        LuuK, KgainK, PKxx = self._terminal(HK, nx)
        # Schur in f64 from the inner-refined W: the master must be
        # assembled to f64 accuracy or it loses positive definiteness
        Schur = -torch.einsum("psb,psc->pbc", MIB, W)
        Schur = Schur.reshape(qp.batch_shape + (P,) + Schur.shape[-2:])
        master, dM = self._master_build(Schur, Hb, PKxx, nx)
        return PartFactors(Minv=Minv, Dscale=Dd, MII=MII_s, W=W, MIB=MIB,
                           master=master, dM=dM, LuuK=LuuK, KgainK=KgainK)

    # -- solve ---------------------------------------------------------------

    @log.spanned("partitioned.reduced")
    def solve_reduced(self, fac: PartFactors, qp: StageQP, g, r2dyn):
        """Solve [-H A'; A 0][dx; dy] = [g; r2] via the partition Schur."""
        nx, nu, nv = qp.nx, qp.nu, qp.nv
        L, P, dims = self._dims(qp)
        off_y = dims[-1][2]
        lead = qp.batch_shape
        gx, gu = g[..., :nx], g[..., nx:]

        gsp = g[..., :-1, :].reshape(-1, L, nv)
        BP = gsp.shape[0]
        # interior rhs in the order [u_{pL} | v_{pL+1..} | y_{pL..}], the
        # partitions of a batch flattened
        rhoI = torch.cat([gsp[:, 0, nx:], gsp[:, 1:].reshape(BP, -1),
                          r2dyn.reshape(BP, L * nx)], dim=1)

        rhoB = gx[..., ::L, :].clone()
        rhoB[..., -1, :] = gx[..., -1, :] - sl.mv(fac.KgainK.mT,
                                                  gu[..., -1, :])

        # condense the interiors onto the boundaries
        inner = self._inner()
        t = _interior_apply((fac.Minv, fac.Dscale, fac.MII), rhoI, inner)
        corr = torch.einsum("psb,ps->pb", fac.MIB, t)     # [P, 2nx]
        corr = corr.reshape(lead + (P, 2 * nx))
        rhoB[..., :-1, :] -= corr[..., :nx]
        rhoB[..., 1:, :] -= corr[..., nx:]

        xB = _master_solve(fac.master, fac.dM, -rhoB, inner)

        # back-substitute the interiors
        xpair = torch.cat([xB[..., :-1, :], xB[..., 1:, :]], dim=-1)
        zeta = t - torch.einsum("psb,pb->ps", fac.W,
                                xpair.reshape(BP, 2 * nx))
        zeta = zeta.reshape(lead + (P, zeta.shape[-1]))
        u0 = zeta[..., :nu]
        vint = zeta[..., nu:off_y].reshape(lead + (P, L - 1, nv))
        dy = zeta[..., off_y:].reshape(lead + (P * L, nx))
        vfull = torch.cat(
            [torch.cat([xB[..., :-1, :], u0], dim=-1)[..., None, :], vint],
            dim=-2)
        duK = -(sl.cho_solve(fac.LuuK, gu[..., -1, :])
                + sl.mv(fac.KgainK, xB[..., -1, :]))
        dx = torch.cat([vfull.reshape(lead + (P * L, nv)),
                        torch.cat([xB[..., -1, :], duK], dim=-1)[..., None,
                                                                 :]],
                       dim=-2)
        return dx, dy

    @log.spanned("partitioned.solve")
    def solve(self, fac, qp: StageQP, z, w, mask, r1, r2, r3, r4):
        """Base solve with ``reg_corr_rounds`` analytic corrections of the
        dual regularization (a Neumann series: re-solve in the reduced
        space on the known residual delta * y of the last correction),
        one multiplier recovery on the accumulated (dx, dy_dyn), then the
        true-residual refinement gate."""
        delta = self._dual_reg()

        def full(a1, a2, a3, a4):
            g, g2 = K_.stage_reduce_rhs(qp, z, w, mask, a1, a2, a3, a4)
            dx, dyd = self.solve_reduced(fac, qp, g2, a2["dyn"])
            ylast = dyd
            for _ in range(self.reg_corr_rounds):
                cx, cyd = self.solve_reduced(fac, qp, torch.zeros_like(g2),
                                             delta * ylast)
                dx, dyd, ylast = dx + cx, dyd + cyd, cyd
            return K_.stage_recover(qp, z, w, mask, g, dx, dyd, a2, a3, a4)

        sol = full(r1, r2, r3, r4)
        return K_.refine(full, qp, z, w, mask, r1, r2, r3, r4, sol,
                         eps=self._refine_eps(),
                         max_rounds=self._refine_rounds(),
                         relative=self.refine_relative)


modules.register("qp_mat_solver", "SpSC")(PartitionedKKT)
modules.register("qp_mat_solver", "LQDOCP")(PartitionedKKT)

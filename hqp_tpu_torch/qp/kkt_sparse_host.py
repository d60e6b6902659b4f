"""Host-sparse KKT backends of the general (DenseQP) path.

Port of ``hqp_tpu/qp/kkt_sparse_host.py``: the reference's
Hqp_IpRedSpBKP / Hqp_IpSpBKP roles for CUTE-scale sparse problems.  The
QP and the interior point stay on the QP's device; each factorization
assembles the KKT matrix on the host in scipy CSR and factors it with the
port's build of the native sparse kernels (:mod:`hqp_tpu_torch.native`),
as the reference does behind ``pure_callback``.  Right-hand sides,
residuals and refinement run on the device.

* :class:`SparseHostKKT` (``qp_mat_solver RedSpBKP_host``): the reduced
  quasidefinite saddle [-H A'; A dI], H = Q + C' W^-1 Z C, by the sparse
  LDL' under an RCM order fixed at the first factorization.
* :class:`SparseCallbackKKT` (``qp_mat_solver RedSpBKP``): the same
  saddle with the reference's structure-once discipline: a symbolic
  record (union pattern, RCM order, elimination tree) per problem shape,
  each factorization projected onto it.
* :class:`FullSparseBKPKKT` (``qp_mat_solver SpBKP``): the full 3x3
  system by the sparse Bunch-Kaufman-Parlett factorization.

Data movement: Q, C and A go to the host once per IP solve
(:meth:`prepare`, which Mehrotra calls; a backend handed another QP
re-pins it); the barrier data once per factorization; each right-hand
side to the host and each solution back to the QP's device.  Every copy
goes through :meth:`_d2h` or :meth:`_h2d`, which count its bytes in
``moved``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from hqp_tpu_torch.native import SparseBKP, SparseLDL, rcm_order
from hqp_tpu_torch.qp import kkt as K_
from hqp_tpu_torch.qp.program import DenseIneq, DenseQP
from hqp_tpu_torch.utils import masked as mk
from hqp_tpu_torch.utils.registry import modules
from hqp_tpu_torch.utils.sync import host, to_host


def _refine(base, qp, z, w, mask, r, sol, eps, rounds):
    """The reference's host-backend refinement: while the KKT residual is
    above ``eps`` (absolute) and fewer than ``rounds`` corrections were
    made, re-solve on the residual and keep the correction only if the
    residual fell.  One host read per residual."""
    *errs, res = K_.kkt_residual(qp, z, w, mask, *r, *sol)
    res = host(res)
    for _ in range(rounds):
        if res <= eps:
            break
        cx, cy, cz, cw = base(*errs)
        dx, dy, dz, dw = sol
        new = (dx + cx, dy + cy, mk.add(dz, cz), mk.add(dw, cw))
        *nerrs, nres = K_.kkt_residual(qp, z, w, mask, *r, *new)
        nres = host(nres)
        if not nres < res:
            break
        sol, errs, res = new, nerrs, nres
    return sol


class _HostKKT:
    """Host copies of a QP's matrices and the counted transfers."""

    def __init__(self):
        self._prep = None
        self._prep_qp = None
        #: bytes copied device -> host and host -> device
        self.moved = {"d2h": 0, "h2d": 0}

    def _d2h(self, t):
        self.moved["d2h"] += t.numel() * t.element_size()
        return to_host(t)

    def _h2d(self, a, device):
        self.moved["h2d"] += a.nbytes
        return torch.from_numpy(a).to(device)

    def prepare(self, qp: DenseQP):
        """Pin Q, C, A (equality rows masked) and the equality mask on the
        host, once per IP solve, and remember which QP they came from."""
        Q, C, A, em = (self._d2h(t) for t in (qp.Q, qp.C, qp.A,
                                              qp.eq_mask_))
        self._prep = self._pin(Q, C, A * em[:, None], em)
        self._prep_qp = qp

    def _pin(self, Q, C, A, em):
        return Q, C, A, em

    def _pinned(self, qp):
        """The host copies of ``qp``'s matrices (re-pinned if the backend
        was prepared with another QP)."""
        if self._prep_qp is not qp:
            self.prepare(qp)
        return self._prep

    def _solve_host(self, solve, rhs, perm, device):
        """rhs -> host, permuted solve, solution -> ``device``."""
        b = self._d2h(rhs)
        if perm is None:
            return self._h2d(solve(b), device)
        sol = solve(b[perm])
        out = np.empty_like(sol)
        out[perm] = sol
        return self._h2d(out, device)


def _saddle(H, A, dual_reg):
    """[-H A'; A dual_reg I] in CSR with sorted indices (-H alone without
    equality rows)."""
    me = A.shape[0]
    if me:
        K = sp.bmat([[-H, A.T], [A, dual_reg * sp.eye(me)]], format="csr")
    else:
        K = sp.csr_matrix(-H)
    K = sp.csr_matrix(K)
    K.sort_indices()
    return K


class SparseHostKKT(_HostKKT):
    """Sparse LDL' of the reduced saddle under an RCM order computed at the
    first factorization, with up to ``refine_rounds`` refinement rounds."""

    def __init__(self, dual_reg: float = 1e-10, reg: float = 1e-12,
                 refine_rounds: int = 5, refine_eps: float = 1e-10,
                 use_rcm: bool = True):
        super().__init__()
        self.dual_reg = dual_reg
        self.reg = reg
        self.refine_rounds = refine_rounds
        self.refine_eps = refine_eps
        self.use_rcm = use_rcm
        self._perm = None

    def factor(self, qp: DenseQP, z, w, mask):
        Q, C, A, _ = self._pinned(qp)
        sig = self._d2h(K_.barrier_ratios(z, w, mask).g)
        H = Q + (C.T * sig) @ C
        Ksys = _saddle(sp.csr_matrix(H), sp.csr_matrix(A), self.dual_reg)
        if self.use_rcm and self._perm is None:
            self._perm = rcm_order(Ksys.shape[0], Ksys.indptr, Ksys.indices)
        if self.use_rcm:
            p = self._perm
            Ksys = Ksys[p][:, p].tocsr()
            Ksys.sort_indices()
        f = SparseLDL(Ksys.shape[0], Ksys.indptr, Ksys.indices)
        return f.factor(Ksys.data, reg=self.reg)

    def solve(self, fac, qp: DenseQP, z, w, mask, r1, r2, r3, r4):
        n, me = qp.n, qp.me
        perm = self._perm if self.use_rcm else None

        def base(a1, a2, a3, a4):
            g = K_.reduce_r1(qp, z, w, mask, a1, a3, a4)
            rhs = torch.cat([g, a2]) if me else g
            sol = self._solve_host(fac.solve, rhs, perm, qp.device)
            dx, dy = sol[:n], sol[n:]
            dz, dw = K_.recover_zw(qp, z, w, mask, dx, a3, a4)
            return dx, dy, dz, dw

        return _refine(base, qp, z, w, mask, (r1, r2, r3, r4),
                       base(r1, r2, r3, r4), self.refine_eps,
                       self.refine_rounds)


modules.register("qp_mat_solver", "RedSpBKP_host")(SparseHostKKT)


class SparseCallbackKKT(_HostKKT):
    """The reference's structure-once / factor-each-iteration discipline
    (hqp/Hqp_IpRedSpBKP.C:281 -> spBKP.C:369): a symbolic record per
    problem shape (n, me) holds the union pattern of every saddle seen,
    its RCM order, the map of pattern slots to the permuted CSR data and
    the LDL' handle with its elimination tree; each factorization
    projects the numeric saddle onto it, and rebuilds it from the union
    pattern when an entry falls outside.  A factorization is a token; the
    last two stay alive.  One refinement round (``refine_rounds``)
    against an absolute residual of 1e-10."""

    def __init__(self, dual_reg: float = 1e-10, reg: float = 1e-12,
                 refine_rounds: int = 1, use_rcm: bool = True):
        super().__init__()
        self.dual_reg = dual_reg
        self.reg = reg
        self.refine_rounds = refine_rounds
        self.use_rcm = use_rcm
        self._sym = {}       # (n, me) -> symbolic record
        self._token = 0
        self._live = {}      # token -> symbolic record (the last two)

    def _pin(self, Q, C, A, em):
        return sp.csr_matrix(Q), sp.csr_matrix(C), sp.csr_matrix(A)

    def _symbolic(self, key, pat):
        """Symbolic record of a saddle pattern: the pattern's sorted
        row-major keys, its RCM permutation, the map of pattern slots to
        the permuted CSR data and the LDL' handle."""
        pat = sp.csr_matrix(pat)
        pat.sort_indices()
        N = pat.shape[0]
        # numeric data is projected onto the pattern by searchsorted on
        # these keys: scipy's CSR addition prunes explicit zeros, so a
        # sum-based projection would drop pattern slots
        rows = np.repeat(np.arange(N, dtype=np.int64), np.diff(pat.indptr))
        pat_keys = rows * np.int64(N) + pat.indices.astype(np.int64)
        perm = rcm_order(N, pat.indptr, pat.indices) if self.use_rcm \
            else np.arange(N)
        T = pat.copy()
        # 1-based positions: value 0 must not collide with a pruned slot
        T.data = np.arange(1, pat.nnz + 1, dtype=np.float64)
        Tp = T[perm][:, perm].tocsr()
        Tp.sort_indices()
        rec = dict(pat_keys=pat_keys, pat=pat, perm=np.asarray(perm),
                   data_map=Tp.data.astype(np.int64) - 1,
                   ldl=SparseLDL(Tp.shape[0], Tp.indptr, Tp.indices),
                   nnz=pat.nnz)
        self._sym[key] = rec
        return rec

    def _host_factor(self, Qs, Cs, As, sig):
        """Assemble the saddle, project it onto the symbolic record and
        factor it; returns the new token."""
        n, me = Qs.shape[0], As.shape[0]
        key = (n, me)
        m = Cs.shape[0]
        H = (Qs + Cs.T @ sp.diags([sig], [0], shape=(m, m)) @ Cs).tocsr()
        Knum = _saddle(H, As, self.dual_reg)
        N = Knum.shape[0]
        krows = np.repeat(np.arange(N, dtype=np.int64),
                          np.diff(Knum.indptr))
        kkeys = krows * np.int64(N) + Knum.indices.astype(np.int64)
        rec = self._sym.get(key)
        if rec is not None:
            pos = np.searchsorted(rec["pat_keys"], kkeys)
            grown = (pos >= rec["nnz"]) if rec["nnz"] else \
                np.ones_like(pos, bool)
            ok = not bool(np.any(grown)) and bool(np.all(
                rec["pat_keys"][np.minimum(pos, rec["nnz"] - 1)] == kkeys))
            if not ok:
                # the pattern grew (an exact Hessian filled new entries at
                # a later SQP iterate): rebuild from the union pattern
                rec = None
        if rec is None:
            patn = Knum.copy()
            patn.data = np.ones_like(patn.data)
            old = self._sym.get(key)
            if old is not None:
                pat_old = old["pat"].copy()
                pat_old.data = np.ones_like(pat_old.data)
                patn = (patn + pat_old).tocsr()
            rec = self._symbolic(key, patn)
            pos = np.searchsorted(rec["pat_keys"], kkeys)
        data_full = np.zeros(rec["nnz"])
        data_full[pos] = Knum.data
        rec["ldl"].factor(data_full[rec["data_map"]], reg=self.reg)
        self._token += 1
        self._live[self._token] = rec
        for k in [k for k in self._live if k < self._token - 1]:
            del self._live[k]
        return self._token

    def _host_solve(self, token, rhs):
        """Solve with the factorization of ``token`` (host arrays)."""
        rec = self._live.get(token)
        if rec is None:
            raise RuntimeError(
                f"SparseCallbackKKT: no live factorization for token "
                f"{token} (live: {sorted(self._live)})")
        p = rec["perm"]
        sol = rec["ldl"].solve(rhs[p])
        out = np.empty_like(sol)
        out[p] = sol
        return out

    def factor(self, qp: DenseQP, z, w, mask):
        Qs, Cs, As = self._pinned(qp)
        sig = self._d2h(K_.barrier_ratios(z, w, mask).g)
        return self._host_factor(Qs, Cs, As, sig)

    def solve(self, fac, qp: DenseQP, z, w, mask, r1, r2, r3, r4):
        n, me = qp.n, qp.me

        def base(a1, a2, a3, a4):
            g = K_.reduce_r1(qp, z, w, mask, a1, a3, a4)
            rhs = torch.cat([g, a2]) if me else g
            sol = self._solve_host(lambda b: self._host_solve(fac, b), rhs,
                                   None, qp.device)
            dx, dy = sol[:n], sol[n:]
            dz, dw = K_.recover_zw(qp, z, w, mask, dx, a3, a4)
            return dx, dy, dz, dw

        sol = base(r1, r2, r3, r4)
        if self.refine_rounds > 0:
            sol = _refine(base, qp, z, w, mask, (r1, r2, r3, r4), sol,
                          1e-10, self.refine_rounds)
        return sol


modules.register("qp_mat_solver", "RedSpBKP")(SparseCallbackKKT)


class FullSparseBKPKKT(_HostKKT):
    """The full 3x3 KKT system by the sparse Bunch-Kaufman-Parlett
    factorization (hqp/Hqp_IpSpBKP.C): no reduction and no
    quasidefiniteness assumption.  In the sign convention of
    ``kkt.kkt_residual``

        [-Q   A'  C' ] [dx]   [ r1         ]
        [ A   0   0  ] [dy] = [ r2         ]
        [ C   0  W/Z ] [dz]   [ r3 + r4/z  ]      dw = C dx - r3,

    assembled in CSR (Hqp_IpSpBKP.C:117-137), scaled on the slack rows by
    min(1, sqrt(z/w)) (:158-176), with dead rows pinned to a unit
    diagonal.  ``pinned`` records each factorization's count of 1x1
    pivots floored at ``reg`` or pinned to 1.0."""

    def __init__(self, tol: float = 1.0, reg: float = 0.0,
                 refine_rounds: int = 3, refine_eps: float = 1e-10,
                 use_rcm: bool = True):
        super().__init__()
        self.tol = tol
        self.reg = reg
        self.refine_rounds = refine_rounds
        self.refine_eps = refine_eps
        self.use_rcm = use_rcm
        self._perm = None
        #: pinned-pivot count of each factorization, in order
        self.pinned = []

    def _pin(self, Q, C, A, em):
        return sp.csr_matrix(Q), C, sp.csr_matrix(A), em

    def factor(self, qp: DenseQP, z, w, mask):
        Q, C, A, em = self._pinned(qp)
        me, mi = qp.me, qp.mi
        zg, wg, mg = self._d2h(torch.stack(
            [z.g, w.g, mask.g.to(z.g.dtype)]))
        mg = mg != 0.0
        C = sp.csr_matrix(C * mg[:, None])
        # slack diagonal w/z on live rows, 1.0 pins on dead rows
        # (Hqp_IpSpBKP.C:131 inserts the raw 1.0 diagonal the same way)
        wz = np.where(mg, wg / np.where(mg, zg, 1.0), 1.0)
        scale = np.where(mg, np.minimum(1.0, np.sqrt(1.0 / wz)), 1.0)
        Wz = sp.diags(wz * scale * scale)
        blocks = [[-Q, A.T if me else None,
                   (C.T @ sp.diags(scale)) if mi else None]]
        if me:
            blocks.append([A, sp.diags(np.where(em, 0.0, 1.0)), None])
        if mi:
            blocks.append([sp.diags(scale) @ C, None, Wz])
        J = sp.bmat(blocks, format="csr")
        J.sort_indices()
        if self.use_rcm:
            if self._perm is None or len(self._perm) != J.shape[0]:
                self._perm = rcm_order(J.shape[0], J.indptr, J.indices)
            p = self._perm
            J = J[p][:, p].tocsr()
            J.sort_indices()
        f = SparseBKP(J.shape[0], J.indptr, J.indices, J.data,
                      tol=self.tol, reg=self.reg)
        self.pinned.append(f.n_pinned)
        return f, self._h2d(scale, qp.device)

    def solve(self, fac, qp: DenseQP, z, w, mask, r1, r2, r3, r4):
        f, scale = fac
        n, me, mi = qp.n, qp.me, qp.mi
        mg = mask.g
        perm = self._perm if self.use_rcm else None

        def base(a1, a2, a3, a4):
            parts = [a1]
            if me:
                parts.append(torch.where(qp.eq_mask_, a2, 0.0))
            if mi:
                r3eff = torch.where(
                    mg, a3.g + a4.g / torch.where(mg, z.g, 1.0), 0.0)
                parts.append(r3eff * scale)
            sol = self._solve_host(f.solve, torch.cat(parts), perm,
                                   qp.device)
            dx, dy = sol[:n], sol[n:n + me]
            dzg = torch.where(mg, sol[n + me:] * scale, 0.0)
            # dw from the path row: C dx - dw = r3  (Hqp_IpSpBKP.C:216)
            dwg = torch.where(mg, qp.matvec_ineq(dx).g - a3.g, 0.0)
            return dx, dy, DenseIneq(g=dzg), DenseIneq(g=dwg)

        return _refine(base, qp, z, w, mask, (r1, r2, r3, r4),
                       base(r1, r2, r3, r4), self.refine_eps,
                       self.refine_rounds)


modules.register("qp_mat_solver", "SpBKP")(FullSparseBKPKKT)

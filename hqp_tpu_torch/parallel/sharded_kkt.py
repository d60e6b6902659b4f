"""Stage-partitioned KKT factorization sharded over ``torch.distributed``.

Port of ``hqp_tpu/parallel/sharded_kkt.py`` (``qp_mat_solver SpSCdist``).
The horizon is split into P partitions of L stages; each rank of the mesh
axis owns P/n of them and eliminates their interiors locally (kernel K1 on
its own [P/n, s, s], :mod:`hqp_tpu_torch.ops.gj_cuda`); the per-partition
boundary Schur blocks are combined over the ranks and the boundary master
system ((P+1) nx unknowns) is factored and solved redundantly on every
rank, by the master the port's :class:`PartitionedKKT` resolves at the
same factor dtype (kernel K2 by default).

The reference runs the whole solve inside one ``shard_map``; here every
rank runs that body on its own rows, SPMD: all ranks hold the same
replicated QP and iterate (the interior-point solver above runs on every
rank), and the collectives the reference's ``shard_map`` inserts are
explicit ``all_reduce`` calls in the same layout:

* the replicated gathers (the reference's psum of a zero-padded slot,
  ``_gather_replicated``) are an ``all_reduce(SUM)`` of the same slots;
* the one-row halos (the reference's non-cyclic ``ppermute``) are an
  ``all_reduce(SUM)`` of each rank's edge row in its slot, from which a rank
  takes its neighbour's: the first and the last rank get zeros;
* the boundary data of a reduced solve (Schur corrections, partition-start
  rows, terminal row) travel in ONE fused ``all_reduce``;
* the residual norms of the refinement are local maxima over the owned
  rows and one ``all_reduce(MAX)``; every rank then reads the same value,
  so all ranks take the same branch and call the same collectives;
* the direction's rows come back to every rank in one ``all_reduce`` of
  the zero-padded whole (the reference's ``out_specs`` gather).

Each rank's view holds its stage rows plus ONE halo row (the right
neighbour's first stage; the terminal stage on the last rank), so every
per-stage operation runs verbatim on a local :class:`StageQP`; the -I
coupling of the left neighbour's last dynamics row is the one term that
crosses a rank boundary (``_RankView.matvec_eqT``).

``full_shard=False`` is the reference's other layout: the factorization is
the same, but the solve is :class:`PartitionedKKT`'s, run replicated on
every rank (the stage work, the base solve, the regularization corrections
and the refinement on the whole QP), and only its reduced solves are split
over the ranks: each rank condenses its own interiors, the boundary
corrections are gathered by one ``all_reduce``, the master is solved on
every rank, and the back-substituted rows of every rank come back in one
more ``all_reduce`` (two collectives per reduced solve, none in the
refinement's norms).  A collective that fails raises; nothing falls back
to a single-device solve.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from hqp_tpu_torch.ops import smalllin as sl
from hqp_tpu_torch.qp import kkt as K_
from hqp_tpu_torch.qp.kkt_partitioned import (PartFactors, PartitionedKKT,
                                              _interior_apply, _master_solve)
from hqp_tpu_torch.qp.program import StageQP
from hqp_tpu_torch.utils import masked as mk
from hqp_tpu_torch.utils.registry import modules
from hqp_tpu_torch.utils.sync import host

#: collectives issued by every ShardedPartitionedKKT of this process
COLLECTIVES = 0

#: the per-stage fields of a StageQP (K + 1 rows)
_K1_FIELDS = ("Q", "c", "lb", "ub", "C", "d_lo", "d_up", "var_mask",
              "con_mask", "E", "e", "eqg_mask")


class _RankView(StageQP):
    """One rank's stage rows of a StageQP plus its halo row.  The adjoint
    of the dynamics adds the -I coupling of the left neighbour's last
    dynamics row (one exchange; zero on the first rank)."""

    def matvec_eqT(self, y):
        out = super().matvec_eqT(y)
        out[0, : self.nx] -= self.backend.from_left(y["dyn"][-1])
        return out


class ShardedPartitionedKKT(PartitionedKKT):
    """PartitionedKKT with the partition axis sharded over a device mesh
    (``torch.distributed.device_mesh.DeviceMesh``, e.g. from
    :func:`hqp_tpu_torch.parallel.distributed.global_mesh`) axis ``axis``.

    Every keyword of :class:`PartitionedKKT` passes through with its
    meaning there (``refine_rounds``, ``reg_corr_rounds``, ``refine_eps``,
    ``dual_reg``, ``gj``, ``refine_relative``, ``factor_dtype``,
    ``master``).  ``full_shard``: True (default) runs the whole solve on
    each rank's rows; False the reference's replicated solve around
    sharded reduced solves (module docstring)."""

    def __init__(self, mesh, axis: str = "sp", L: int = 16,
                 refine_rounds: int | None = None,
                 full_shard: bool = True, **kw):
        super().__init__(L=L, refine_rounds=refine_rounds, **kw)
        self.full_shard = full_shard
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.shape[mesh.mesh_dim_names.index(axis)]
        self.index = mesh.get_local_rank(axis)
        self.group = mesh.get_group(axis)

    def _config(self):
        return super()._config() + (self.mesh, self.axis,
                                    self.full_shard)

    # -- layout: P must divide evenly over the ranks ---------------------------

    def _choose_L(self, K, nx, nu):
        nd = self.ndev
        Lmin = max(2, -(-nx // max(nu, 1)) + 1)
        best = None
        for L in range(1, K + 1):
            if K % L or L < Lmin or (K // L) % nd:
                continue
            d = abs(L - self.L)
            if best is None or d < best[0]:
                best = (d, L)
        if best is None:
            raise ValueError(
                f"no partition length L >= {Lmin} divides K={K} into a "
                f"multiple of {nd} devices; pad the horizon")
        return best[1]

    # -- collectives -----------------------------------------------------------

    def _all_reduce(self, t, op=dist.ReduceOp.SUM):
        global COLLECTIVES
        COLLECTIVES += 1
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def _gather_replicated(self, local):
        """Per-partition blocks of every rank, [P, ...] on each: the local
        blocks in their slot of a zero array, summed over the ranks."""
        Pl = local.shape[0]
        full = local.new_zeros((Pl * self.ndev,) + tuple(local.shape[1:]))
        full[self.index * Pl:(self.index + 1) * Pl] = local
        return self._all_reduce(full)

    def _exchange(self, row, shift):
        """Every rank's ``row`` moved ``shift`` ranks up (the reference's
        non-cyclic ppermute): a rank without such a neighbour gets zeros."""
        slots = row.new_zeros((self.ndev,) + tuple(row.shape))
        slots[self.index] = row
        self._all_reduce(slots)
        j = self.index - shift
        return slots[j] if 0 <= j < self.ndev else torch.zeros_like(row)

    def from_left(self, row):
        """The left neighbour's ``row`` (zeros on the first rank)."""
        return self._exchange(row, 1)

    def from_right(self, row):
        """The right neighbour's ``row`` (zeros on the last rank)."""
        return self._exchange(row, -1)

    def _own_max(self, own, *pairs):
        """Largest |a| over the owned rows of every (tree, mask tree or
        None) pair, on this rank."""
        tops = [torch.zeros((), dtype=torch.float64, device=own.device)]
        for tree, tmask in pairs:
            ms = mk.leaves(tmask) if tmask is not None else None
            for i, a in enumerate(mk.leaves(tree)):
                if not a.numel():
                    continue
                a = a.abs()
                if ms is not None:
                    a = torch.where(ms[i], a, 0.0)
                o = own[: a.shape[0]].reshape((a.shape[0],)
                                              + (1,) * (a.dim() - 1))
                tops.append(torch.where(o, a, 0.0).max())
        return torch.stack(tops).max()

    # -- sharded factor --------------------------------------------------------

    def _rows(self, qp: StageQP):
        """(L, P, dims, this rank's first stage, its end)."""
        if qp.nb:
            raise ValueError("ShardedPartitionedKKT takes one QP; a batch "
                             "of QPs is sharded by shard_batch")
        L, P, dims = self._dims(qp)
        Kl = P // self.ndev * L
        return L, P, dims, self.index * Kl, (self.index + 1) * Kl

    def factor(self, qp: StageQP, z, w, mask):
        """Factor this rank's partition interiors (one K1 launch on its
        P/n), gather the boundary Schur blocks, factor the master."""
        nx = qp.nx
        L, P, dims, _, _ = self._rows(qp)
        H = self._hess(qp, z, w, mask)
        Hs, As, mm_int, mm_e, Hb, HK = self._split_stage_data(qp, H, L, P)
        Pl = P // self.ndev
        own = slice(self.index * Pl, (self.index + 1) * Pl)
        MII, MIB = self._partition_blocks(Hs[own], As[own], mm_int[own],
                                          mm_e[own], dims, self._dual_reg())
        Minv, Dd, MII_s, W = self._interior_factor(MII, MIB)
        Schur = self._gather_replicated(-torch.einsum("psb,psc->pbc", MIB, W))
        LuuK, KgainK, PKxx = self._terminal(HK, nx)
        master, dM = self._master_build(Schur, Hb, PKxx, nx)
        return PartFactors(Minv=Minv, Dscale=Dd, MII=MII_s, W=W, MIB=MIB,
                           master=master, dM=dM, LuuK=LuuK, KgainK=KgainK)

    # -- sharded solve ---------------------------------------------------------

    def _condense(self, dims, fac, gsp, r2dyn):
        """This rank's interiors condensed onto the boundaries: the
        interior solutions t [Pl, s] and the boundary corrections
        [Pl, 2nx], from its partitions' rows of g [Pl, L, nv] and of the
        dynamics residual."""
        L, s, nx, nu, nv, _ = dims
        Pl = gsp.shape[0]
        rhoI = torch.cat([gsp[:, 0, nx:], gsp[:, 1:].reshape(Pl, -1),
                          r2dyn.reshape(Pl, L * nx)], dim=1)
        t = _interior_apply((fac.Minv, fac.Dscale, fac.MII), rhoI,
                            self._inner())
        return t, torch.einsum("psb,ps->pb", fac.MIB, t)

    def _boundary_solve(self, fac, rhoB, corr, nx):
        """The replicated master solve on the gathered boundary data."""
        rhoB[:-1] -= corr[:, :nx]
        rhoB[1:] -= corr[:, nx:]
        return _master_solve(fac.master, fac.dM, -rhoB, self._inner())

    def _backsub(self, dims, fac, t, xB):
        """This rank's interiors back-substituted from the boundary
        states: its stage rows of dx [Pl L, nv] and dy_dyn [Pl L, nx]."""
        L, s, nx, nu, nv, (_, _, off_y) = dims
        Pl = t.shape[0]
        xs = xB[self.index * Pl:self.index * Pl + Pl + 1]
        xpair = torch.cat([xs[:-1], xs[1:]], dim=1)
        zeta = t - torch.einsum("psb,pb->ps", fac.W, xpair)
        vint = zeta[:, nu:off_y].reshape(Pl, L - 1, nv)
        vfull = torch.cat([torch.cat([xs[:-1], zeta[:, :nu]], dim=-1)[:, None],
                           vint], dim=1).reshape(Pl * L, nv)
        return vfull, zeta[:, off_y:].reshape(Pl * L, nx)

    def _reduced_solve_local(self, dims, fac, g2, r2dyn, last):
        """Reduced saddle solve on the local view: local interiors and the
        replicated master.  Returns (dx [Kl + 1] with a valid halo row,
        dy_dyn [Kl])."""
        L, s, nx, nu, nv, _ = dims
        Pl = fac.Minv.shape[0]
        P, i0 = Pl * self.ndev, self.index * Pl
        t, corr_l = self._condense(dims, fac, g2[:-1].reshape(Pl, L, nv),
                                   r2dyn)
        # ONE fused all_reduce carries all boundary data: the Schur
        # corrections, the partition-start rows of g and the terminal row
        # (the last rank's halo)
        pay = g2.new_zeros(P * 3 * nx + nv)
        pay[i0 * 2 * nx:(i0 + Pl) * 2 * nx] = corr_l.reshape(-1)
        pay[P * 2 * nx + i0 * nx:P * 2 * nx + (i0 + Pl) * nx] = \
            g2[:-1:L, :nx].reshape(-1)
        if last:
            pay[P * 3 * nx:] = g2[-1]
        self._all_reduce(pay)
        gT = pay[P * 3 * nx:]
        rhoB = torch.cat([pay[P * 2 * nx:P * 3 * nx].reshape(P, nx),
                          (gT[:nx] - sl.mv(fac.KgainK.mT, gT[nx:]))[None]])
        xB = self._boundary_solve(fac, rhoB,
                                  pay[:P * 2 * nx].reshape(P, 2 * nx), nx)
        vfull, dyd = self._backsub(dims, fac, t, xB)
        duK = -(sl.cho_solve(fac.LuuK, gT[nx:]) + sl.mv(fac.KgainK, xB[-1]))
        halo = self.from_right(vfull[0])
        if last:
            halo = torch.cat([xB[-1], duK])
        return torch.cat([vfull, halo[None]]), dyd

    def solve_reduced(self, fac: PartFactors, qp: StageQP, g, r2dyn):
        """``full_shard=False``'s reduced solve (the reference's
        ``_local_solve``): this rank condenses its own interiors, one
        all_reduce gathers the boundary corrections, the master is solved
        on every rank, and one all_reduce gathers the back-substituted
        rows of every rank."""
        nx, nv = qp.nx, qp.nv
        L, P, dims, k0, k1 = self._rows(qp)
        Pl = P // self.ndev
        t, corr_l = self._condense(dims, fac, g[k0:k1].reshape(Pl, L, nv),
                                   r2dyn[k0:k1])
        rhoB = g[::L, :nx].clone()
        rhoB[-1] -= sl.mv(fac.KgainK.mT, g[-1, nx:])
        xB = self._boundary_solve(fac, rhoB, self._gather_replicated(corr_l),
                                  nx)
        vfull, dyd = self._backsub(dims, fac, t, xB)
        rows = g.new_zeros((P * L, nv + nx))
        rows[k0:k1] = torch.cat([vfull, dyd], dim=1)
        rows = self._all_reduce(rows)
        duK = -(sl.cho_solve(fac.LuuK, g[-1, nx:]) + sl.mv(fac.KgainK,
                                                           xB[-1]))
        dx = torch.cat([rows[:, :nv], torch.cat([xB[-1], duK])[None]])
        return dx, rows[:, nv:]

    def _base_solve_local(self, dims, qp_loc, fac, z, w, mask,
                          r1, r2, r3, r4, last):
        """Base solve, the reduced-space corrections of the dual
        regularization and one recovery on the local view (the structure
        of PartitionedKKT.solve's base solve)."""
        g, g2 = K_.stage_reduce_rhs(qp_loc, z, w, mask, r1, r2, r3, r4)
        dx, dyd = self._reduced_solve_local(dims, fac, g2, r2["dyn"], last)
        delta = self._dual_reg()
        ylast = dyd
        for _ in range(self.reg_corr_rounds):
            cx, cyd = self._reduced_solve_local(
                dims, fac, torch.zeros_like(g2), delta * ylast, last)
            dx, dyd, ylast = dx + cx, dyd + cyd, cyd
        return K_.stage_recover(qp_loc, z, w, mask, g, dx, dyd, r2, r3, r4)

    def _residual(self, qp_loc, z, w, mask, rhs, sol, own):
        """The KKT residual on the local view and its largest entry over
        the owned rows of this rank (the halo row counts on the last rank
        only, where it is the terminal stage)."""
        *errs, _ = K_.kkt_residual(qp_loc, z, w, mask, *rhs, *sol)
        return errs, self._own_max(own, *((e, None) for e in errs))

    def _refine(self, base, qp_loc, z, w, mask, rhs, sol, own):
        """K_.refine's loop (entry test, monotone guard, the tolerance
        rhs-scaled unless ``refine_relative`` is False) on the local view,
        each norm over all ranks by one all_reduce(MAX)."""
        rounds = self._refine_rounds()
        if rounds <= 0:
            return sol
        r1, r2, r3, r4 = rhs
        emask = qp_loc.eq_mask()
        sc = self._own_max(own, (r1, qp_loc.x_mask()),
                           ({k: r2[k] for k in emask}, emask),
                           (r3, mask), (r4, mask))
        errs, res = self._residual(qp_loc, z, w, mask, rhs, sol, own)
        res, sc = self._all_reduce(torch.stack([res, sc]),
                                   dist.ReduceOp.MAX)
        eps = self._refine_eps()
        if self.refine_relative:
            eps = eps * torch.clamp(sc, min=1.0)
        go = host(res > eps)
        i = 0
        while go and i < rounds:
            cx, cy, cz, cw = base(*errs)
            dx, dy, dz, dw = sol
            new = (dx + cx, mk.add(dy, cy), mk.add(dz, cz), mk.add(dw, cw))
            nerrs, nres = self._residual(qp_loc, z, w, mask, rhs, new, own)
            self._all_reduce(nres, dist.ReduceOp.MAX)
            better, above = host(torch.stack([nres < res, nres > eps]))
            if not better:
                break
            sol, errs, res = new, nerrs, nres
            go = above
            i += 1
        return sol

    def solve(self, fac, qp: StageQP, z, w, mask, r1, r2, r3, r4):
        """The whole solve on this rank's rows, the direction gathered on
        every rank; with ``full_shard=False`` PartitionedKKT's solve on
        every rank around the sharded :meth:`solve_reduced`."""
        if not self.full_shard:
            return super().solve(fac, qp, z, w, mask, r1, r2, r3, r4)
        L, P, dims, k0, k1 = self._rows(qp)
        last = self.index == self.ndev - 1

        def cut(a):
            return a[k0:k1 + 1]

        fields = {f: cut(getattr(qp, f)) for f in _K1_FIELDS
                  if getattr(qp, f) is not None}
        qp_loc = _RankView(A=qp.A[k0:k1], b=qp.b[k0:k1], **fields)
        qp_loc.backend = self
        z, w, mask, r1, r3, r4 = (mk.tmap(cut, a) for a in
                                  (z, w, mask, r1, r3, r4))
        r2 = {k: (v[k0:k1] if k == "dyn" else cut(v)) for k, v in r2.items()}
        own = torch.arange(k1 - k0 + 1, device=qp.device) < k1 - k0
        own |= last

        def base(a1, a2, a3, a4):
            return self._base_solve_local(dims, qp_loc, fac, z, w, mask,
                                          a1, a2, a3, a4, last)

        rhs = (r1, r2, r3, r4)
        sol = self._refine(base, qp_loc, z, w, mask, rhs, base(*rhs), own)
        return self._gather_rows(sol, qp.K, k0, k1, last)

    def _gather_rows(self, sol, K, k0, k1, last):
        """Every rank's rows of (dx, dy, dz, dw) on every rank: each leaf
        zero-padded to its whole length with this rank's rows (and the
        terminal row on the last rank), in one all_reduce."""
        dx, dy, dz, dw = sol
        parts = [(dx, None), (dy["dyn"], "dyn")]
        parts += [(dy[k], None) for k in dy if k != "dyn"]
        parts += [(a, None) for a in mk.leaves(dz) + mk.leaves(dw)]
        whole = []
        for a, kind in parts:
            out = a.new_zeros((K + (kind is None),) + tuple(a.shape[1:]))
            if kind is None:
                out[k0:k1] = a[:-1]
                if last:
                    out[K] = a[-1]
            else:
                out[k0:k1] = a
            whole.append(out)
        flat = self._all_reduce(torch.cat([o.reshape(-1) for o in whole]))
        outs = list(torch.split(flat, [o.numel() for o in whole]))
        outs = [f.reshape(o.shape) for f, o in zip(outs, whole)]
        dx = outs.pop(0)
        dy = {"dyn": outs.pop(0), **{k: outs.pop(0) for k in dy
                                    if k != "dyn"}}
        n = len(mk.leaves(dz))
        return (dx, dy, type(dz)(*outs[:n]), type(dw)(*outs[n:]))


modules.register("qp_mat_solver", "SpSCdist")(ShardedPartitionedKKT)

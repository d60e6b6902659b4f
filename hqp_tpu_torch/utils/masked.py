"""Masked reductions over dataclasses and dicts of tensors.

Port of ``hqp_tpu/utils/masked.py``.  The reference's pytrees become plain
containers: a *tree* here is a tensor, ``None`` (no leaves), a dict (keys
visited in sorted order, as ``jax.tree_util`` does), a tuple of trees or a
dataclass whose fields are trees (visited in declaration order).
:func:`tmap` maps a function over the leaves of one or more trees of
identical structure and rebuilds the container.

The reductions flatten every leaf into one vector first, so a masked norm
over the four inequality groups is one concatenation and one reduction
instead of one reduction per group.  Maxima and minima are exact under any
order; sums may differ from the reference's per-leaf order in the last bit.

A batch of problems carries ``nb`` leading batch axes on every leaf (a
scenario batch: ``nb = 1``).  The reductions take ``nb`` and then reduce
each problem's leaves over their trailing axes alone, giving a tensor of
the batch shape; with ``nb = 0`` (the default) they are the unbatched
reductions.  :func:`bc` lines a per-problem value up against a leaf.
"""

from __future__ import annotations

import dataclasses

import torch

BIG = 1e300


def tmap(f, *trees):
    """Apply ``f`` leaf-wise over trees of identical structure."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: tmap(f, *(t[k] for t in trees)) for k in sorted(t0)}
    if isinstance(t0, tuple):
        return tuple(tmap(f, *(t[i] for t in trees)) for i in range(len(t0)))
    if dataclasses.is_dataclass(t0):
        return type(t0)(**{
            fl.name: tmap(f, *(getattr(t, fl.name) for t in trees))
            for fl in dataclasses.fields(t0)})
    return f(*trees)


def leaves(tree):
    """The tensor leaves of a tree, in :func:`tmap` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in leaves(tree[k])]
    if isinstance(tree, tuple):
        return [l for t in tree for l in leaves(t)]
    if dataclasses.is_dataclass(tree):
        return [l for fl in dataclasses.fields(tree)
                for l in leaves(getattr(tree, fl.name))]
    return [tree]


def flat(tree, nb=0):
    """All leaves raveled and concatenated, in :func:`tmap` order (the
    counterpart of ``jax.flatten_util.ravel_pytree``); with ``nb`` batch
    axes, each problem's leaves: ``[*batch, n]``."""
    ls = leaves(tree)
    if nb:
        rows = [l.reshape(l.shape[:nb] + (-1,)) for l in ls]
        return rows[0] if len(rows) == 1 else torch.cat(rows, dim=-1)
    if len(ls) == 1:
        return ls[0].reshape(-1)
    return torch.cat([l.reshape(-1) for l in ls])


def _reduce(vec, op, init, nb=0):
    if nb:
        if vec.shape[-1] == 0:
            return torch.full(vec.shape[:-1], init, dtype=vec.dtype,
                              device=vec.device)
        return op(vec, dim=-1)
    if vec.numel() == 0:
        return torch.full((), init, dtype=vec.dtype, device=vec.device)
    return op(vec)


def bc(s, like):
    """A per-problem value ``s`` ([*batch]) with unit axes appended so that
    it broadcasts against the leaf ``like`` ([*batch, ...]).  Python
    numbers and 0-d tensors (the unbatched case) come back as they are."""
    if not isinstance(s, torch.Tensor) or s.dim() == 0:
        return s
    return s.reshape(s.shape + (1,) * (like.dim() - s.dim()))


def amax_all(a, nb=0):
    """Largest entry of one tensor, per problem with ``nb`` batch axes."""
    return a.amax() if nb == 0 else a.reshape(a.shape[:nb] + (-1,)).amax(-1)


def inner(a, b, mask=None, nb=0):
    """Masked inner product <a, b>."""
    p = flat(a, nb) * flat(b, nb)
    if mask is not None:
        p = torch.where(flat(mask, nb), p, 0.0)
    return _reduce(p, torch.sum, 0.0, nb)


def total(a, mask=None, nb=0):
    """Masked sum of all entries."""
    v = flat(a, nb)
    if mask is not None:
        v = torch.where(flat(mask, nb), v, 0.0)
    return _reduce(v, torch.sum, 0.0, nb)


def count(mask, nb=0):
    """Number of valid entries of a boolean mask tree (float64)."""
    return _reduce(flat(mask, nb).to(torch.float64), torch.sum, 0.0, nb)


def tsize(tree) -> int:
    """Static total element count."""
    return sum(l.numel() for l in leaves(tree))


def norm_inf(a, mask=None, nb=0):
    """Masked infinity norm (0 for an empty mask)."""
    v = flat(a, nb).abs()
    if mask is not None:
        v = torch.where(flat(mask, nb), v, 0.0)
    return _reduce(v, torch.amax, 0.0, nb)


def vmin(a, mask=None, nb=0):
    """Masked minimum entry (BIG if the mask is empty)."""
    v = flat(a, nb)
    if mask is not None:
        v = torch.where(flat(mask, nb), v, BIG)
    return _reduce(v, torch.amin, float("inf"), nb)


def vmax(a, mask=None, nb=0):
    v = flat(a, nb)
    if mask is not None:
        v = torch.where(flat(mask, nb), v, -BIG)
    return _reduce(v, torch.amax, float("-inf"), nb)


def where(mask, a, b):
    """Leaf-wise select; ``b`` may be a Python scalar."""
    if isinstance(b, (int, float)):
        return tmap(lambda m, x: torch.where(m, x, b), mask, a)
    return tmap(torch.where, mask, a, b)


def sel(cond, a, b):
    """Leaf-wise ``cond ? a : b`` with one ``cond`` per problem (0-d
    unbatched, [*batch] for a batch)."""
    return tmap(lambda ai, bi: torch.where(bc(cond, ai), ai, bi), a, b)


def fill(tree, value):
    """Tree of the same structure filled with a constant.  Boolean leaves
    (masks) are promoted to float64."""
    def leaf(x):
        dt = x.dtype if x.is_floating_point() else torch.float64
        return torch.full(x.shape, value, dtype=dt, device=x.device)

    return tmap(leaf, tree)


def axpy(alpha, x, y):
    """y + alpha * x leaf-wise (``alpha`` one per problem)."""
    return tmap(lambda xi, yi: yi + bc(alpha, xi) * xi, x, y)


def add(a, b):
    return tmap(torch.add, a, b)


def sub(a, b):
    return tmap(torch.sub, a, b)


def scale(alpha, a):
    return tmap(lambda x: bc(alpha, x) * x, a)


def ratio_min(num, den, mask, nb=0):
    """min over valid entries of -num/den where den < 0, else BIG -- the
    fraction-to-boundary step (hqp/Hqp_IpsMehrotra.C:564-574)."""
    n, d = flat(num, nb), flat(den, nb)
    ok = flat(mask, nb) & (d < 0.0)
    r = torch.where(ok, -n / torch.where(ok, d, -1.0), BIG)
    return torch.clamp(_reduce(r, torch.amin, BIG, nb), max=BIG)

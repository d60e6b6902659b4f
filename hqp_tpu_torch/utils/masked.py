"""Masked reductions over dataclasses and dicts of tensors.

Port of ``hqp_tpu/utils/masked.py``.  The reference's pytrees become plain
containers: a *tree* here is a tensor, ``None`` (no leaves), a dict (keys
visited in sorted order, as ``jax.tree_util`` does) or a dataclass whose
fields are trees (visited in declaration order).  :func:`tmap` maps a
function over the leaves of one or more trees of identical structure and
rebuilds the container.

The reductions flatten every leaf into one vector first, so a masked norm
over the four inequality groups is one concatenation and one reduction
instead of one reduction per group.  Maxima and minima are exact under any
order; sums may differ from the reference's per-leaf order in the last bit.
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
    if dataclasses.is_dataclass(tree):
        return [l for fl in dataclasses.fields(tree)
                for l in leaves(getattr(tree, fl.name))]
    return [tree]


def flat(tree):
    """All leaves raveled and concatenated, in :func:`tmap` order (the
    counterpart of ``jax.flatten_util.ravel_pytree``)."""
    ls = leaves(tree)
    if len(ls) == 1:
        return ls[0].reshape(-1)
    return torch.cat([l.reshape(-1) for l in ls])


def _reduce(vec, op, init):
    if vec.numel() == 0:
        return torch.full((), init, dtype=vec.dtype, device=vec.device)
    return op(vec)


def inner(a, b, mask=None):
    """Masked inner product <a, b>."""
    p = flat(a) * flat(b)
    if mask is not None:
        p = torch.where(flat(mask), p, 0.0)
    return _reduce(p, torch.sum, 0.0)


def total(a, mask=None):
    """Masked sum of all entries."""
    v = flat(a)
    if mask is not None:
        v = torch.where(flat(mask), v, 0.0)
    return _reduce(v, torch.sum, 0.0)


def count(mask):
    """Number of valid entries of a boolean mask tree (float64)."""
    return _reduce(flat(mask).to(torch.float64), torch.sum, 0.0)


def tsize(tree) -> int:
    """Static total element count."""
    return sum(l.numel() for l in leaves(tree))


def norm_inf(a, mask=None):
    """Masked infinity norm (0 for an empty mask)."""
    v = flat(a).abs()
    if mask is not None:
        v = torch.where(flat(mask), v, 0.0)
    return _reduce(v, torch.amax, 0.0)


def vmin(a, mask=None):
    """Masked minimum entry (BIG if the mask is empty)."""
    v = flat(a)
    if mask is not None:
        v = torch.where(flat(mask), v, BIG)
    return _reduce(v, torch.amin, float("inf"))


def vmax(a, mask=None):
    v = flat(a)
    if mask is not None:
        v = torch.where(flat(mask), v, -BIG)
    return _reduce(v, torch.amax, float("-inf"))


def where(mask, a, b):
    """Leaf-wise select; ``b`` may be a Python scalar."""
    if isinstance(b, (int, float)):
        return tmap(lambda m, x: torch.where(m, x, b), mask, a)
    return tmap(torch.where, mask, a, b)


def fill(tree, value):
    """Tree of the same structure filled with a constant.  Boolean leaves
    (masks) are promoted to float64."""
    def leaf(x):
        dt = x.dtype if x.is_floating_point() else torch.float64
        return torch.full(x.shape, value, dtype=dt, device=x.device)

    return tmap(leaf, tree)


def axpy(alpha, x, y):
    """y + alpha * x leaf-wise."""
    return tmap(lambda xi, yi: yi + alpha * xi, x, y)


def add(a, b):
    return tmap(torch.add, a, b)


def sub(a, b):
    return tmap(torch.sub, a, b)


def scale(alpha, a):
    return tmap(lambda x: alpha * x, a)


def ratio_min(num, den, mask):
    """min over valid entries of -num/den where den < 0, else BIG -- the
    fraction-to-boundary step (hqp/Hqp_IpsMehrotra.C:564-574)."""
    n, d = flat(num), flat(den)
    ok = flat(mask) & (d < 0.0)
    r = torch.where(ok, -n / torch.where(ok, d, -1.0), BIG)
    return torch.clamp(_reduce(r, torch.amin, BIG), max=BIG)

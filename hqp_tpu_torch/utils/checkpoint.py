"""Checkpoint / resume of solver state.

Port of ``hqp_tpu/utils/checkpoint.py``.  The reference has no file
checkpointing -- its resume mechanism is the in-memory hot-start state
(``hqp_solve_hot``, the ``_qp_Q_hot`` Hessian snapshot, the IP's
``_z_hot``/``_w_hot``).  Here the solver state (x, y, z, the Hessian,
the IP iterate with its hot pair, the last step and QP solution, the
Lagrangian gradient, and the counters) round-trips through one ``.npz``:
one array per tensor, named by its path through the dicts and
dataclasses that hold it (``ip_state/z/bl``), plus a JSON ``meta``
entry.  Nothing is pickled, so the file names no class of this package.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from hqp_tpu_torch.utils.sync import to_host

#: the solver attributes a checkpoint holds ("Q" is the QP's Hessian)
_STATE = ("x", "y", "z", "Q", "ip_state", "d", "s", "grd_L")
_META = ("iter", "inf_iters", "alpha", "status", "f", "qp_iters_total")


def _children(tree):
    """(name, child) pairs of a dict (sorted keys), tuple or dataclass."""
    if isinstance(tree, dict):
        return sorted(tree.items())
    if isinstance(tree, tuple):
        return [(str(i), t) for i, t in enumerate(tree)]
    return [(fl.name, getattr(tree, fl.name))
            for fl in dataclasses.fields(tree)]


def _flatten(tree, name, out):
    """Every tensor of ``tree`` into ``out`` under its path (counted host
    copies); None leaves are left out."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        out[name] = to_host(tree)
        return
    for k, child in _children(tree):
        _flatten(child, f"{name}/{k}", out)


def _unflatten(like, name, arrays, device):
    """The tree of ``like``'s structure from ``arrays``, each tensor a
    fresh one on ``device``; a tensor or None leaf of ``like`` takes the
    array stored under its path (None if there is none)."""
    if like is None or isinstance(like, torch.Tensor):
        a = arrays.get(name)
        return None if a is None else \
            torch.as_tensor(a, device=device).clone()
    kids = {k: _unflatten(c, f"{name}/{k}", arrays, device)
            for k, c in _children(like)}
    if isinstance(like, dict):
        return kids
    if isinstance(like, tuple):
        return tuple(kids[str(i)] for i in range(len(like)))
    return type(like)(**kids)


def save_solver(path, solver):
    """Checkpoint an SqpSolver mid-run (or converged, for MPC resume)."""
    state = {k: getattr(solver, k) for k in _STATE if k != "Q"}
    state["Q"] = solver.qp.Q if solver.qp is not None else None
    arrays = {}
    for key, val in state.items():
        _flatten(val, key, arrays)
    meta = {k: getattr(solver, k) for k in _META}
    meta["alpha"] = float(meta["alpha"])
    meta["status"] = int(meta["status"])
    meta["f"] = None if solver.f is None else float(to_host(solver.f))
    arrays["meta"] = np.array(json.dumps(meta))
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def load_solver(path, solver):
    """Restore a checkpoint into a freshly ``init()``-ed solver of the
    same program; returns the solver.  Every tensor is a new one on the
    solver's device: the restored solver shares no storage with the one
    that saved."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays.pop("meta")))
    dev = solver.x.device
    # d, s and grd_L have x's structure; after init() they are still None
    like = {"x": solver.x, "y": solver.y, "z": solver.z, "Q": solver.qp.Q,
            "ip_state": solver.ip_state, "d": solver.x, "s": solver.x,
            "grd_L": solver.x}
    state = {k: _unflatten(like[k], k, arrays, dev) for k in _STATE}
    solver.x, solver.y, solver.z = state["x"], state["y"], state["z"]
    if state["Q"] is not None:
        solver.f, solver.qp = solver.prg.make_qp(solver.x, Q=state["Q"])
    solver.ip_state = state["ip_state"]
    solver.d, solver.s, solver.grd_L = state["d"], state["s"], state["grd_L"]
    for k in ("iter", "inf_iters", "alpha", "status", "qp_iters_total"):
        setattr(solver, k, meta[k])
    return solver

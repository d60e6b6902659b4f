"""Checkpoint / resume of solver state.

Port of ``hqp_tpu/utils/checkpoint.py``.  The reference has no file
checkpointing -- its resume mechanism is the in-memory hot-start state
(``hqp_solve_hot``, the ``_qp_Q_hot`` Hessian snapshot, the IP's
``_z_hot``/``_w_hot``).  Here the solver state (x, y, z, the Hessian,
the IP iterate with its hot pair, the last step and QP solution, the
Lagrangian gradient, and the counters) round-trips through one ``.npz``
written by :func:`save_pytree`, which keeps a user's own nested dicts,
lists and tuples of tensors the same way: one array per tensor, the
structure (a dataclass as its fields by name) and a ``meta`` dict as JSON
entries beside them.  Nothing is pickled, so the file names no class of
this package: :func:`load_solver` takes the classes from the solver it
restores into.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from hqp_tpu_torch.docp.program import resolve_device
from hqp_tpu_torch.utils.sync import to_host

#: the solver attributes a checkpoint holds ("Q" is the QP's Hessian)
_STATE = ("x", "y", "z", "Q", "ip_state", "d", "s", "grd_L")
_META = ("iter", "inf_iters", "alpha", "status", "f", "qp_iters_total")


def _spec(tree, leaves):
    """The JSON structure of ``tree``, its tensors appended to ``leaves``
    (counted host copies) and named by their index; a dataclass is kept
    as its fields by name."""
    if isinstance(tree, torch.Tensor):
        leaves.append(to_host(tree))
        return {"leaf": len(leaves) - 1}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {"fields": [[fl.name, _spec(getattr(tree, fl.name), leaves)]
                           for fl in dataclasses.fields(tree)]}
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError("save_pytree: dict keys must be str")
        return {"dict": [[k, _spec(v, leaves)] for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_spec(v, leaves) for v in tree]}
    raise TypeError(f"save_pytree: cannot save a {type(tree).__name__}")


def _build(spec, arrays, device, like):
    """The tree of ``spec``, each tensor a new one on ``device``; a
    dataclass's fields come back as an instance of the class of ``like``'s
    node at the same place, or as a dict where ``like`` has none."""
    if "leaf" in spec:
        return torch.as_tensor(arrays[f"leaf{spec['leaf']}"],
                               device=device).clone()
    if "value" in spec:
        return spec["value"]
    if "fields" in spec:
        kids = {k: _build(v, arrays, device, getattr(like, k, None))
                for k, v in spec["fields"]}
        return kids if like is None else type(like)(**kids)
    if "dict" in spec:
        sub = like if isinstance(like, dict) else {}
        return {k: _build(v, arrays, device, sub.get(k))
                for k, v in spec["dict"]}
    kind, items = next(iter(spec.items()))
    sub = like if isinstance(like, (list, tuple)) else ()
    kids = [_build(v, arrays, device, sub[i] if i < len(sub) else None)
            for i, v in enumerate(items)]
    return kids if kind == "list" else tuple(kids)


def save_pytree(path, tree, meta=None):
    """Save nested dicts (str keys), lists, tuples and dataclasses of
    tensors (and of None, bool, int, float or str), with a JSON-able
    ``meta`` dict, to the ``.npz`` file ``path``: one array per tensor,
    the structure and meta as JSON."""
    leaves = []
    spec = _spec(tree, leaves)
    arrays = {f"leaf{i}": a for i, a in enumerate(leaves)}
    arrays["tree"] = np.array(json.dumps(spec))
    arrays["meta"] = np.array(json.dumps(meta or {}))
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def load_pytree(path, device="cuda", like=None):
    """(tree, meta) saved by :func:`save_pytree`, every tensor a new one
    on ``device`` (the card unless the caller asks for another; raises
    without one).  A saved dataclass comes back as a dict of its fields,
    or as the class of the dataclass at the same place in ``like``."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    tree = _build(json.loads(str(arrays["tree"])), arrays, device, like)
    return tree, json.loads(str(arrays["meta"]))


def save_solver(path, solver):
    """Checkpoint an SqpSolver mid-run (or converged, for MPC resume)."""
    state = {k: getattr(solver, k) for k in _STATE if k != "Q"}
    state["Q"] = solver.qp.Q if solver.qp is not None else None
    meta = {k: getattr(solver, k) for k in _META}
    meta["alpha"] = float(meta["alpha"])
    meta["status"] = int(meta["status"])
    meta["f"] = None if solver.f is None else float(to_host(solver.f))
    save_pytree(path, state, meta)


def load_solver(path, solver):
    """Restore a checkpoint into a freshly ``init()``-ed solver of the
    same program; returns the solver.  Every tensor is a new one on the
    solver's device: the restored solver shares no storage with the one
    that saved."""
    like = {"z": solver.z, "ip_state": solver.ip_state}
    state, meta = load_pytree(path, solver.x.device, like)
    solver.x, solver.y, solver.z = state["x"], state["y"], state["z"]
    if state["Q"] is not None:
        solver.f, solver.qp = solver.prg.make_qp(solver.x, Q=state["Q"])
    solver.ip_state = state["ip_state"]
    solver.d, solver.s, solver.grd_L = state["d"], state["s"], state["grd_L"]
    for k in ("iter", "inf_iters", "alpha", "status", "qp_iters_total"):
        setattr(solver, k, meta[k])
    return solver

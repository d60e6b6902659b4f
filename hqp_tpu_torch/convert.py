"""numpy -> port data.

The port never imports JAX, so data crosses between the two packages as
numpy arrays: anything ``numpy.asarray`` accepts (numpy arrays, and the
reference package's device arrays) goes in, tensors on the requested
device come out: the card unless the caller names another device, and an
exception where the card is asked for and there is none.  Floating data
becomes float64, boolean masks stay bool.
Tests use these helpers to hand both packages the same inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hqp_tpu_torch.docp.program import resolve_device
from hqp_tpu_torch.qp.program import DenseQP, IneqGroups, StageQP

_INEQ_FIELDS = ("bl", "bu", "gl", "gu")


def tensor(a, device="cuda"):
    """One array -> tensor (float64 unless boolean or integer)."""
    device = resolve_device(device)
    a = np.array(a)  # a writable copy (device arrays export read-only)
    if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a.astype(np.float64), device=device)


def ineq(src, device="cuda") -> IneqGroups:
    """Object or dict with bl/bu/gl/gu -> IneqGroups."""
    get = src.get if isinstance(src, dict) else \
        (lambda f: getattr(src, f))
    return IneqGroups(*[tensor(get(f), device) for f in _INEQ_FIELDS])


def eq(src: dict, device="cuda") -> dict:
    """Equality-group dict (``dyn``/``fix``/``gen``) -> dict of tensors."""
    return {k: tensor(v, device) for k, v in src.items()}


def program_record(src) -> np.ndarray:
    """A program's measurement record (``s_ref`` of a CranePar program of
    either package after its setup, or the array itself) as a host float64
    array: what ``PrgCranePar(s_ref=...)`` takes, so that both packages
    fit the same measurements."""
    return np.array(getattr(src, "s_ref", src), dtype=np.float64)


def stage_qp(src, device="cuda") -> StageQP:
    """Any object with StageQP's attribute names -> StageQP."""
    kw = {}
    for fl in dataclasses.fields(StageQP):
        v = getattr(src, fl.name, None)
        kw[fl.name] = None if v is None else tensor(v, device)
    return StageQP(**kw)


def dense_qp(src, device="cuda") -> DenseQP:
    """Any object with DenseQP's attribute names -> DenseQP."""
    return DenseQP(**{fl.name: tensor(getattr(src, fl.name), device)
                      for fl in dataclasses.fields(DenseQP)})

"""The traffic generator: draws made from the seed alone."""

import pytest
import torch

from portbench.core import spec, traffic
from portbench.reference import did

CFG = {"kmax": 40, "with_cns": True}


def _draws(seed, batch=0, n=2):
    base = did.base_iterate(CFG, "cpu")
    d = traffic.Draws(base, batch, 1e-3, seed, "cpu")
    return [d.next() for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 12345678901234])
def test_same_seed_same_draws(seed):
    a, b = _draws(seed), _draws(seed)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])          # a sequence, not a repeat


def test_other_seed_other_draws():
    a, b = _draws(3), _draws(4)
    assert not torch.equal(a[0], b[0])


def test_batch_shape_and_scale():
    (v,) = _draws(5, batch=8, n=1)
    base = did.base_iterate(CFG, "cpu")
    assert v.shape == (8,) + tuple(base.shape) and v.dtype == torch.float64
    noise = v - base
    assert 0.5e-3 < float(noise.std()) < 1.5e-3


def test_base_iterate_is_the_programs_setup():
    from hqp_tpu_torch.models.did import PrgDID
    prg = PrgDID(kmax=CFG["kmax"], device="cpu")
    assert torch.equal(prg.setup(), did.base_iterate(CFG, "cpu"))


@pytest.mark.parametrize("bad", [{"loop": "open", "start": "cold",
                                  "scale": 1e-3},
                                 {"loop": "closed", "start": "hot",
                                  "scale": 1e-3},
                                 {"loop": "closed", "start": "cold"}])
def test_generator_refuses_what_it_does_not_make(bad):
    with pytest.raises(ValueError):
        traffic.check_traffic(bad)


def test_cells_traffic_is_made_by_the_generator():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        traffic.check_traffic(spec.load_cell(w["name"], bench).traffic)

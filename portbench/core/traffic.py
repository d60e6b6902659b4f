"""The general traffic generator: perturbed iterates drawn from the seed.

A traffic mix is a JSON file of parameters (``portbench/traffic/``):

- ``loop``: ``"closed"``, the only loop: the next unit of work is sent
  when the last one has returned;
- ``start``: ``"cold"``, the only start: every QP is solved from the
  solver's cold start;
- ``scale``: the standard deviation of the perturbation.

Each unit of work is the configuration's base iterate (its plain
reference's ``base_iterate``) plus ``scale`` times standard normal noise
on every entry, drawn in float64 on the run's device by one
``torch.Generator`` seeded with the run's seed: ``batch`` iterates at
once where the configuration solves a batch, else one.  The same seed
gives the same sequence of draws (HQP's scenario draw rule, BASELINE
config 5; ``hqp_tpu_torch.parallel.scenarios.batched_qp`` draws the same
way on the host).
"""

from __future__ import annotations

import torch

LOOPS = ("closed",)
STARTS = ("cold",)


def check_traffic(traffic):
    """Refuse a mix this generator does not make."""
    if traffic.get("loop") not in LOOPS:
        raise ValueError(f"traffic {traffic.get('name')}: loop "
                         f"{traffic.get('loop')!r}; this generator makes "
                         f"{LOOPS}")
    if traffic.get("start") not in STARTS:
        raise ValueError(f"traffic {traffic.get('name')}: start "
                         f"{traffic.get('start')!r}; this generator makes "
                         f"{STARTS}")
    if not float(traffic.get("scale", -1.0)) >= 0.0:
        raise ValueError(f"traffic {traffic.get('name')}: scale must be "
                         ">= 0")


class Draws:
    """The run's sequence of perturbed iterates."""

    def __init__(self, base, batch, scale, seed, device):
        self.base = base
        self.shape = ((batch,) if batch else ()) + tuple(base.shape)
        self.scale = float(scale)
        # any whole number is a seed: fold it into the generator's range
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 63))
        self.device = device

    def next(self):
        noise = torch.randn(self.shape, generator=self.gen,
                            dtype=torch.float64, device=self.device)
        return self.base + self.scale * noise

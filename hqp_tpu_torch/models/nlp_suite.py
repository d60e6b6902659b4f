"""Small constrained NLP test problems from the reference's odc suite.

Port of ``hqp_tpu/models/nlp_suite.py``: TP383 (odc/Prg_TP383.C),
Maratos (odc/Prg_Maratos.C) and HS99 (odc/Prg_HS99.C), stage-free
problems on the general dense-QP path, registered under ``prg_name``.
"""

from __future__ import annotations

import numpy as np
import torch

from hqp_tpu_torch.docp.nlp import Nlp
from hqp_tpu_torch.utils.registry import modules

_TP383_A = [12842.275, 634.25, 634.25, 634.125, 1268.0, 633.875, 633.75,
            1267.0, 760.05, 633.25, 1266.25, 632.875, 394.46, 940.838]
_TP383_C = [5.47934, 0.83234, 0.94749, 1.11082, 2.64824, 1.55868, 1.73215,
            3.90896, 2.74284, 2.60541, 5.96184, 3.29522, 1.83517, 2.81372]


@modules.register("prg_name", "TP383")
class PrgTP383(Nlp):
    """Schittkowski TP383: min sum a_i/x_i  s.t. sum c_i x_i = 1, bounds
    (odc/Prg_TP383.C:25-59)."""

    name = "TP383"
    n = 14
    m = 1

    def __init__(self, device="cuda"):
        super().__init__(device)
        f = dict(dtype=torch.float64, device=self.device)
        self._a = torch.tensor(_TP383_A, **f)
        self._c = torch.tensor(_TP383_C, **f)

    def setup_vars(self):
        x_min = np.zeros(14)
        x_max = np.concatenate([np.full(5, 0.04), np.full(9, 0.03)])
        return dict(x_min=x_min, x_max=x_max, x_init=np.full(14, 0.01),
                    c_min=[1.0], c_max=[1.0])

    def f0(self, x):
        return (self._a / x).sum()

    def c(self, x):
        return (self._c * x).sum()[None]


@modules.register("prg_name", "Maratos")
class PrgMaratos(Nlp):
    """Maratos-effect problem (odc/Prg_Maratos.C): min -x1 + 10(x1^2+x2^2-1)
    s.t. x1^2 + x2^2 = 1;  f* = -1 at (1, 0)."""

    name = "Maratos"
    n = 2
    m = 1

    def setup_vars(self):
        return dict(x_init=[0.8, 0.6], c_min=[0.0], c_max=[0.0])

    def f0(self, x):
        return -x[0] + 10.0 * (x[0] ** 2 + x[1] ** 2 - 1.0)

    def c(self, x):
        return (x[0] ** 2 + x[1] ** 2 - 1.0)[None]


_HS99_A = [0.0, 50.0, 50.0, 75.0, 75.0, 75.0, 100.0, 100.0]
_HS99_T = [0.0, 25.0, 50.0, 100.0, 150.0, 200.0, 290.0, 380.0]
_HS99_B = 32.0


@modules.register("prg_name", "HS99")
class PrgHS99(Nlp):
    """Hock-Schittkowski 99 (odc/Prg_HS99.C): rocket ascent angles;
    f* = -0.831079892e9."""

    name = "HS99"
    n = 7
    m = 2

    def setup_vars(self):
        return dict(x_min=np.zeros(7), x_max=np.full(7, 1.58),
                    x_init=np.full(7, 0.5),
                    c_min=[1e5, 1e3], c_max=[1e5, 1e3])

    def _integrate(self, x):
        r = q = s = 0.0
        for i in range(1, 8):
            dt = _HS99_T[i] - _HS99_T[i - 1]
            r = r + _HS99_A[i] * torch.cos(x[i - 1]) * dt
            p = (_HS99_A[i] * torch.sin(x[i - 1]) - _HS99_B) * dt
            q = q + (0.5 * p + s) * dt
            s = s + p
        return r, q, s

    def f0(self, x):
        r, q, s = self._integrate(x)
        return -r * r

    def c(self, x):
        r, q, s = self._integrate(x)
        return torch.stack([q, s])

"""Counted device-to-host reads.

The reference runs its interior-point loop, the refinement loop and the
step branch on the device (``lax.while_loop``/``lax.cond``).  The port
runs them as host loops, and each loop test reads one small tensor back
with :func:`host`, which waits for the device.  The host-sparse KKT
backends copy their matrices and right-hand sides to the host with
:func:`to_host`.  ``COUNT`` counts both kinds of read, and every other
read made through :func:`read`, so that a run can report its host syncs
per IP iteration.  While the port's spans record
(:data:`hqp_tpu_torch.utils.log.TRACING`), each read is also timed and
charged to the innermost open span.
"""

from __future__ import annotations

from hqp_tpu_torch.utils import log

#: number of counted reads since import (reset freely by callers)
COUNT = 0


def read(fn):
    """``fn()``, a device-to-host read: counted, and timed into the
    innermost open span while tracing."""
    global COUNT
    COUNT += 1
    if log.TRACING:
        return log.timers.host_read(fn)
    return fn()


def host(t):
    """``t.tolist()`` -- a Python scalar for a 0-d tensor, else a list."""
    return read(t.tolist)


def to_host(t):
    """``t.cpu().numpy()`` -- a counted copy of a tensor to host memory."""
    return read(lambda: t.detach().cpu().numpy())

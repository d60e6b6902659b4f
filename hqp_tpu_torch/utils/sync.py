"""Counted device-to-host reads.

The reference runs its interior-point loop, the refinement loop and the
step branch on the device (``lax.while_loop``/``lax.cond``).  The port
runs them as host loops, and each loop test reads one small tensor back
with :func:`host`, which waits for the device.  The host-sparse KKT
backends copy their matrices and right-hand sides to the host with
:func:`to_host`.  ``COUNT`` counts both kinds of read, so that a run can
report its host syncs per IP iteration.
"""

from __future__ import annotations

#: number of :func:`host` and :func:`to_host` reads since import (reset
#: freely by callers)
COUNT = 0


def host(t):
    """``t.tolist()`` -- a Python scalar for a 0-d tensor, else a list."""
    global COUNT
    COUNT += 1
    return t.tolist()


def to_host(t):
    """``t.cpu().numpy()`` -- a counted copy of a tensor to host memory."""
    global COUNT
    COUNT += 1
    return t.detach().cpu().numpy()

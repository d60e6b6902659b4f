"""Client QP solver: ship each QP to a worker process.

Port of ``hqp_tpu/qp/client.py``: the role of the reference's Hqp_Client
(hqp/Hqp_Client.{h,C}: writes the sparse QP over named pipes to an
external solver process and reads x, y, z back -- its only
process-boundary hook).  The transport is length-prefixed pickles over a
worker subprocess's stdin and stdout; the remote end runs the port's own
Mehrotra solver (``python -m hqp_tpu_torch.qp.client`` is the worker).
The class implements Mehrotra's (init_state / solve) protocol, so it
drops into the SQP loop as ``sqp_qp_solver Client``.

Device rule: the QP and IP state cross as host tensors, and the worker
rebuilds them on the device the job names, which is the QP's own device.
A QP on the card is solved on the card inside the worker (its KKT
backend launches the port's kernels there); a job that names CUDA on a
worker without it fails, and the Client raises the worker's message.
Nothing falls back to the CPU.  ``Client.moved`` counts the bytes each
way, ``Client.launches`` the kernel launches the worker reports, and
``Client.seconds`` splits the wall time of the round trips into the
worker's solve and the transport around it.
"""

from __future__ import annotations

import os
import pickle
import struct
import subprocess
import sys
import time

from hqp_tpu_torch.utils import masked as mk
from hqp_tpu_torch.utils import sync
from hqp_tpu_torch.utils.registry import modules


def _write_msg(pipe, obj):
    data = pickle.dumps(obj)
    pipe.write(struct.pack("<Q", len(data)))
    pipe.write(data)
    pipe.flush()


def _read_msg(pipe):
    hdr = pipe.read(8)
    if len(hdr) < 8:
        raise EOFError("client pipe closed")
    (n,) = struct.unpack("<Q", hdr)
    return pickle.loads(pipe.read(n))


def _to_host(tree):
    """Every tensor of a QP or IP state as a compact host copy (a copy a
    tensor, each a counted host read when it leaves the card)."""
    def one(t):
        def copy():
            return t.detach().to("cpu", copy=True)
        return copy() if t.device.type == "cpu" else sync.read(copy)
    return mk.tmap(one, tree)


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in mk.leaves(tree))


def _to_device(tree, device):
    return mk.tmap(lambda t: t.to(device), tree)


@modules.register("sqp_qp_solver", "Client")
class Client:
    """QP solver proxy over a worker process."""

    def __init__(self, backend=None, eps=1e-9, max_iters=50, **kw):
        from hqp_tpu_torch.qp.mehrotra import Mehrotra
        self.backend = backend  # assigned by the SQP layer; forwarded
        self.eps = eps
        self.max_iters = max_iters
        self._kw = kw
        self._proc = None
        #: local solver used only for state construction (no solve)
        self._local = Mehrotra(eps=eps, max_iters=max_iters, **kw)
        #: bytes of tensor data each way (to the worker, back from it)
        self.moved = {"sent": 0, "received": 0}
        #: kernel launches the worker reported (K1 all routes, K2)
        self.launches = {"K1": 0, "K2": 0}
        #: wall seconds of the round trips and of the worker's solves
        self.seconds = {"round_trip": 0.0, "solve": 0.0}
        self.solves = 0

    def with_backend(self, backend):
        """Rebind contract shared with Mehrotra/Franke (SqpSolver.init)."""
        self.backend = backend
        return self

    def _ensure_worker(self):
        if self._proc is None or self._proc.poll() is not None:
            root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [root] + [p for p in (env.get("PYTHONPATH"),) if p])
            self._proc = subprocess.Popen(
                [sys.executable, "-m", "hqp_tpu_torch.qp.client"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        return self._proc

    def init_state(self, qp):
        return self._local.init_state(qp)

    def _call(self, job):
        """One job to the worker and its reply; raises RuntimeError with
        the worker's message if the worker failed it."""
        p = self._ensure_worker()
        _write_msg(p.stdin, job)
        reply = _read_msg(p.stdout)
        if "error" in reply:
            raise RuntimeError(f"client worker: {reply['error']}")
        return reply

    def solve(self, qp, state, hot: bool = False):
        t0 = time.perf_counter()
        job = {"qp": _to_host(qp), "state": _to_host(state), "hot": hot,
               "eps": self.eps, "max_iters": self.max_iters,
               "backend": type(self.backend).__name__ if self.backend
               else None, "kw": self._kw, "device": str(qp.device)}
        reply = self._call(job)
        out = _to_device(reply["state"], qp.device)
        self.seconds["round_trip"] += time.perf_counter() - t0
        self.seconds["solve"] += reply["seconds"]
        self.moved["sent"] += _nbytes(job["qp"]) + _nbytes(job["state"])
        self.moved["received"] += _nbytes(reply["state"])
        for k in self.launches:
            self.launches[k] += reply["launches"][k]
        self.solves += 1
        return out

    def close(self):
        if self._proc is not None and self._proc.poll() is None:
            self._proc.stdin.close()
            self._proc.wait(timeout=10)
        self._proc = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


#: the backends a job may name (class name -> module), built with their
#: default settings as the reference package's worker builds them
_BACKENDS = {"DenseKKT": "hqp_tpu_torch.qp.kkt",
             "FullStageKKT": "hqp_tpu_torch.qp.kkt",
             "RiccatiKKT": "hqp_tpu_torch.qp.kkt",
             "PartitionedKKT": "hqp_tpu_torch.qp.kkt_partitioned"}


def _backend(name):
    import importlib
    return getattr(importlib.import_module(
        _BACKENDS.get(name, "hqp_tpu_torch.qp.kkt")),
        name if name in _BACKENDS else "DenseKKT")()


def _launches():
    from hqp_tpu_torch.ops import gj_cuda, thomas_cuda
    return {"K1": gj_cuda.LAUNCHES + gj_cuda.LAUNCHES_LARGE,
            "K2": thomas_cuda.LAUNCHES}


def _serve(stdin, stdout):
    """Worker loop: read QP jobs, solve each with Mehrotra on the job's
    device, reply with the state as host tensors, the kernel launches of
    the solve and its wall seconds."""
    from hqp_tpu_torch.docp.program import resolve_device
    from hqp_tpu_torch.qp.mehrotra import Mehrotra
    while True:
        try:
            job = _read_msg(stdin)
        except EOFError:
            return
        try:
            dev = resolve_device(job["device"])
            solver = Mehrotra(backend=_backend(job["backend"]),
                              eps=job["eps"], max_iters=job["max_iters"],
                              **job["kw"])
            qp = _to_device(job["qp"], dev)
            state = _to_device(job["state"], dev)
            before = _launches()
            t0 = time.perf_counter()
            state = _to_host(solver.solve(qp, state, hot=job["hot"]))
            secs = time.perf_counter() - t0
            after = _launches()
            _write_msg(stdout, {
                "state": state, "seconds": secs,
                "launches": {k: after[k] - before[k] for k in after}})
        except Exception as e:  # report, keep serving
            _write_msg(stdout, {"error": f"{type(e).__name__}: {e}"})


if __name__ == "__main__":
    # stdout is the protocol channel: keep its descriptor for the
    # protocol, and send everything else written to fd 1 or sys.stdout
    # (the solvers' logging, a kernel build's output) to stderr
    _proto = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    _serve(sys.stdin.buffer, _proto)

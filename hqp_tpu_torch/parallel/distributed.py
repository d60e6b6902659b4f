"""Multi-process initialization and the device mesh.

Port of ``hqp_tpu/parallel/distributed.py``.  The reference runs
multi-controller JAX: every host runs the same program under
``jax.distributed`` and one global mesh spans all of them.  The port's
counterpart is ``torch.distributed`` with one process per device: every
rank runs the same program on the same replicated data, and the sharded
code (:mod:`hqp_tpu_torch.parallel.sharded_kkt`, ``shard_batch`` in
:mod:`hqp_tpu_torch.parallel.scenarios`) splits the work by its rank in a
``torch.distributed`` device mesh, with explicit collectives
(``all_reduce``) where the reference lets ``shard_map`` insert them.

The backend is ``nccl`` on the card and ``gloo`` on the CPU.  Nothing here
guesses a cluster: the address, the world size and the rank are arguments,
or come from the standard ``torch.distributed`` environment (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK).  A single process gets a one-rank group
without a launcher (an in-process ``HashStore``).  A collective that fails
raises; nothing drops to a single-device solve.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None, device="cuda",
                     timeout: float = 300.0) -> bool:
    """Initialize the default process group if a multi-process run is
    configured; no-op otherwise.

    Resolution order (first hit wins):
      1. explicit arguments (``init_method`` such as
         ``tcp://localhost:29500``, ``world_size``, ``rank``);
      2. the standard environment: MASTER_ADDR and MASTER_PORT give
         ``tcp://MASTER_ADDR:MASTER_PORT``, with WORLD_SIZE and RANK;
      3. ``world_size == 1`` without an address: a one-rank group on an
         in-process HashStore (no launcher, no port);
      4. nothing configured: return False without initializing.

    ``device`` picks the backend (``nccl`` on the card, ``gloo`` on the
    CPU) and, on the card, the rank's device (``cuda:<rank %
    device_count>``).  Returns True iff a
    group is initialized (also when one already was)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and world_size != 1:
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device((rank or 0) % torch.cuda.device_count())
    kw = dict(backend="nccl" if dev.type == "cuda" else "gloo",
              timeout=datetime.timedelta(seconds=timeout))
    if init_method is None:
        dist.init_process_group(store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        if world_size is None or rank is None:
            raise ValueError(f"init_distributed({init_method!r}) needs the "
                             "world size and the rank")
        dist.init_process_group(init_method=init_method,
                                world_size=world_size, rank=rank, **kw)
    return True


def mesh_device_type():
    """The device type of the default group's backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def need_group():
    """Raise unless a process group is initialized."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")


def global_mesh(axes=("sp",)):
    """A device mesh over ALL ranks.

    With one axis the rank order is used.  With two axes the LAST axis is
    laid out within hosts: ('dp', 'sp') puts scenarios across hosts and
    stages within a host, the layout BASELINE's config 5 prescribes.  A
    host's rank count is LOCAL_WORLD_SIZE (set by torchrun), else every
    rank counts as on one host."""
    from torch.distributed.device_mesh import init_device_mesh

    need_group()
    n = dist.get_world_size()
    if len(axes) == 1:
        return init_device_mesh(mesh_device_type(), (n,),
                                mesh_dim_names=tuple(axes))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    rows = max(1, n // local)
    if rows * local != n:
        rows = near_square(n)
    return init_device_mesh(mesh_device_type(), (rows, n // rows),
                            mesh_dim_names=tuple(axes))


def near_square(n):
    """The largest factor of n not above its square root."""
    for f in range(int(n ** 0.5), 0, -1):
        if n % f == 0:
            return f
    return 1


def process_summary():
    """One-line description of the distributed topology (If_Log role)."""
    if not dist.is_initialized():
        return "process 0/1: 1 local / 1 global devices (no process group)"
    n = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    return (f"process {dist.get_rank()}/{n}: {local} local / {n} global "
            f"devices ({dist.get_backend()})")

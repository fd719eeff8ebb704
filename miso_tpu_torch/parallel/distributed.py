"""Multi-process start-up on ``torch.distributed`` and the meshes over every
rank (port of ``miso_tpu/parallel/distributed.py``).

Usage, one call per process before any collective::

    from miso_tpu_torch.parallel import distributed as dist
    dist.initialize()                       # from the environment, or pass args
    mesh = dist.global_mesh(("data",))
    batch = dist.make_global_batch(local_batch, mesh, axis="data")
    step = sharding.data_parallel_train_step(loss_fn, mesh)

Environment variables (read where an argument is omitted), the JAX
package's:
  MISO_COORDINATOR   the rendezvous: host:port of rank 0 ("tcp://" is
                     added), or any ``init_method`` URL (``file://...``)
  MISO_NUM_PROCESSES the number of ranks
  MISO_PROCESS_ID    this rank

The backend is ``nccl`` for CUDA, one rank per card (``device`` is then
``cuda:<rank % cards>`` unless given), and ``gloo`` for CPU tensors or for
ranks that share a card (``backend="gloo"``, ``device="cuda:0"``).  Nothing
switches backend or device by itself: a CUDA request with no card raises.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from miso_tpu_torch.parallel.sharding import Mesh, make_mesh, replicate

TIMEOUT_S = 300.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               timeout_s: float = TIMEOUT_S) -> torch.device:
    """``dist.init_process_group`` from the arguments or the ``MISO_*``
    environment variables, with a timeout on every collective.

    ``backend`` defaults to ``nccl`` (``gloo`` when ``device`` is the CPU).
    Returns this rank's device, made current where it is a card.
    """
    coordinator_address = coordinator_address or os.environ.get("MISO_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ["MISO_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["MISO_PROCESS_ID"])
    if coordinator_address is None:
        raise ValueError("no rendezvous: pass coordinator_address or set MISO_COORDINATOR")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    if device is None:
        device = "cpu" if backend == "gloo" else "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but torch.cuda.is_available() "
                               "is False; pass backend='gloo', device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def process_info() -> Tuple[int, int]:
    """(rank, number of ranks); (0, 1) with no process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_mesh(axes: Sequence[str] = ("data",),
                shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """A mesh over every rank: 1-D over all of them; 2-D by default
    ``(ranks, 1)``, the JAX package's ``(process_count,
    local_device_count)`` with one card to a rank."""
    _, n = process_info()
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        elif len(axes) == 2:
            shape = (n, 1)
        else:
            raise ValueError("pass an explicit shape for more than 2 axes")
    return make_mesh(n, tuple(axes), shape)


def make_global_batch(local_batch: Dict, mesh: Mesh, axis="data", device=None) -> Dict:
    """Each rank's own rows as its shard of the global batch.

    torch has no global array: a rank's tensors hold its rows only, and the
    sharded steps reduce over the mesh.  The rows are moved to ``device``
    as they are; the global batch is the ranks' rows in rank order.
    (``shard_batch`` takes every rank's copy of the global batch instead.)
    """
    del mesh, axis   # each rank already holds exactly its rows
    return {k: torch.as_tensor(v, device=device) for k, v in local_batch.items()}


def replicate_global(tree, mesh: Mesh):
    """Rank 0's values of ``tree`` on every rank of the mesh (a broadcast
    per tensor, in place); the JAX package's "every process must hold
    identical values" becomes a guarantee."""
    return replicate(tree, mesh)

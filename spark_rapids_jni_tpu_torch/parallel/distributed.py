"""Multi-process initialisation: one process a device.

Port of ``spark_rapids_jni_tpu/parallel/distributed.py``. The reference
wires hosts into one JAX system with ``jax.distributed.initialize``; the
port wires one process a device into one ``torch.distributed`` process
group, and every rank then runs the same program (SPMD):

    from spark_rapids_jni_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize(coordinator="file:///tmp/mesh-init",
                           num_processes=4, process_id=rank)
    mesh = make_mesh({"part": 4})
    # run_fused(plan, rels, mesh=mesh) now shards over the four ranks

On CUDA the backend is NCCL (one rank a card: NCCL refuses two ranks on
one device), on the CPU gloo. Nothing tells a process of its cluster:
pass the coordinator, the world size and the rank, or set
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` (``env://``).
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> None:
    """Idempotent ``torch.distributed.init_process_group``.

    ``coordinator`` is ``host:port`` (TCP rendezvous) or a URL such as
    ``file:///path`` or ``tcp://host:port``; None reads the environment
    (``env://``). ``backend`` defaults to NCCL when CUDA is available,
    else gloo. A second call is a no-op."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {"backend": backend}
    if coordinator is not None:
        kwargs["init_method"] = (coordinator if "://" in coordinator
                                 else f"tcp://{coordinator}")
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    if backend == "nccl":
        # one card a rank: the rank's card is its local rank's
        local = int(process_id or 0) % max(1, torch.cuda.device_count())
        torch.cuda.set_device(local)
    dist.init_process_group(**kwargs)


def process_info() -> dict:
    """Rank, world size and devices, under the reference's keys."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": local,
        "global_devices": world,
        "backend": dist.get_backend() if dist.is_initialized() else None,
    }


def shutdown() -> None:
    """Destroy the default process group (a no-op when there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()

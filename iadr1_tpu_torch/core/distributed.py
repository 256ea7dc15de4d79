"""Multi-process bootstrap on ``torch.distributed`` and per-rank batch
slices (counterpart of iadr1_tpu/core/distributed.py).

One process per GPU, launched by ``torchrun`` (or by hand with the JAX
package's variables), NCCL between cards and Gloo on the CPU:

    torchrun --nproc_per_node 8 -m iadr1_tpu_torch.cli.train_sft \
        --config sft.yaml mesh.fsdp=8

``maybe_initialize_distributed()`` does nothing in a single process, so
every CLI calls it unconditionally.  The JAX package's TPU-pod "auto" row
(``TPU_WORKER_HOSTNAMES`` naming several workers, or a Megascale
coordinator) has no counterpart here: that environment reads as a single
process.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

_ENV_COORD = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")
_ENV_NPROC = ("NUM_PROCESSES", "JAX_NUM_PROCESSES")
_ENV_PID = ("PROCESS_ID", "JAX_PROCESS_ID")


def detect_distributed_mode(env: "dict[str, str] | None" = None):
    """Pure decision table for the bootstrap: ("torchrun", kwargs),
    ("explicit", kwargs) or None for a single process.

    torchrun's ``RANK``/``WORLD_SIZE`` (with ``MASTER_ADDR``/
    ``MASTER_PORT``, read by the ``env://`` init) win; else the JAX
    package's explicit ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/
    ``PROCESS_ID`` map to a ``tcp://`` init.  kwargs: ``init_method``,
    ``world_size``, ``rank`` and ``local_rank`` (torchrun's
    ``LOCAL_RANK``; the rank itself for the explicit row, one process per
    card of one host)."""
    env = os.environ if env is None else env

    def pick(names):
        for n in names:
            if env.get(n):
                return env[n]
        return None

    if env.get("RANK") is not None and env.get("WORLD_SIZE"):
        rank = int(env["RANK"])
        return "torchrun", dict(
            init_method="env://", world_size=int(env["WORLD_SIZE"]),
            rank=rank, local_rank=int(env.get("LOCAL_RANK", rank)))
    coord = pick(_ENV_COORD)
    nproc = pick(_ENV_NPROC)
    pid = pick(_ENV_PID)
    if coord and nproc is not None and pid is not None:
        return "explicit", dict(
            init_method=f"tcp://{coord}", world_size=int(nproc),
            rank=int(pid), local_rank=int(pid))
    return None


def maybe_initialize_distributed(device=None) -> bool:
    """Initialise the process group when launched multi-process (a
    torchrun world of one included); returns whether it did.

    ``device`` is the caller's ``--device``: "cpu" takes Gloo, anything
    else NCCL on ``cuda:{local_rank}``, which is made the current device.
    A failed init raises; nothing falls back to Gloo or to one process."""
    mode = detect_distributed_mode()
    if mode is None or dist.is_initialized():
        return False
    kw = dict(mode[1])
    local_rank = kw.pop("local_rank")
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a multi-process launch on the card needs CUDA; pass "
                "--device cpu for the Gloo backend")
        torch.cuda.set_device(local_rank)
    dist.init_process_group("gloo" if cpu else "nccl", **kw)
    return True


@dataclasses.dataclass(frozen=True)
class ProcessTopology:
    """What this process sees of the group: one card a process."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0


def topology() -> ProcessTopology:
    if dist.is_initialized():
        n = dist.get_world_size()
        return ProcessTopology(dist.get_rank(), n, 1, n)
    return ProcessTopology(0, 1, 1, 1)


def is_primary() -> bool:
    """Rank 0, or the only process: the one that logs and writes."""
    return topology().is_primary


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def host_batch_slice(global_batch: int, mesh=None) -> slice:
    """The rows of the global batch this rank feeds: its slice over the
    mesh's dp x fsdp coordinate (the tp ranks of one slice hold the same
    rows).  Without a mesh, every row."""
    from iadr1_tpu_torch.core.mesh import batch_coordinate

    index, count = batch_coordinate(mesh)
    if global_batch % count:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{count} dp x fsdp ranks")
    per_rank = global_batch // count
    return slice(index * per_rank, (index + 1) * per_rank)


def make_global_batch(local_arrays: dict, mesh) -> dict:
    """Per-rank arrays (this rank's rows, ``host_batch_slice``) -> DTensors
    of the global batch, dim 0 sharded over dp and fsdp, replicated over
    tp.  Without a mesh, tensors as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    out = {}
    for key, x in local_arrays.items():
        t = torch.as_tensor(np.asarray(x))
        if mesh is None:
            out[key] = t
            continue
        t = t.to(mesh.device_type)
        placements = [Shard(0) if name != "tp" else Replicate()
                      for name in mesh.mesh_dim_names]
        out[key] = DTensor.from_local(t, mesh, placements, run_check=False)
    return out

"""Data-parallel training over `torch.distributed` (the counterpart of the JAX
trainer's pjit mesh and multi-host loading).

The semantics are those of one pjit step over a batch sharded across
devices: a rank's result is its slice of the one-process result on the
global batch (the ranks' batches concatenated in rank order).

  - The process group comes from torchrun's environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`; `MASTER_ADDR` / `MASTER_PORT`, or the
    rendezvous URL in `GLUEFACTORY_DIST_INIT`, e.g. `file:///tmp/store`):
    NCCL on `cuda:LOCAL_RANK`, gloo on the CPU. A group that fails to form
    raises; nothing falls back to another backend or to one process.
  - Gradients: one flat buffer, all-reduced to the mean (`all_reduce_mean`).
  - Inside `sharded(group)`, which the trainer puts around its forwards,
    `batch_mean` makes a per-rank mean (BatchNorm's statistics) the global
    one, differentiably, and `batch_rand` draws uniform numbers for the
    global batch and keeps the rank's rows, so that every rank draws what
    the one-process run draws for its items.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Group:
    """This process's place in the data-parallel group."""

    rank: int
    world: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0


_group: Group | None = None
_active: Group | None = None


def setup(device: str | torch.device) -> Group | None:
    """The process group of torchrun's environment, formed at the first
    call (NCCL for a CUDA `device`, on `cuda:LOCAL_RANK`; gloo for the CPU);
    None where `WORLD_SIZE` is not set."""
    global _group
    if _group is not None:
        return _group
    if "WORLD_SIZE" not in os.environ:
        return None
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device for the NCCL process group")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=os.environ.get("GLUEFACTORY_DIST_INIT", "env://"),
                                world_size=world, rank=rank)
    if dist.get_backend() != backend or dist.get_world_size() != world:
        raise RuntimeError(f"process group {dist.get_backend()} of {dist.get_world_size()} ranks, "
                           f"expected {backend} of {world}")
    _group = Group(rank, world, dev)
    return _group


def teardown() -> None:
    """Destroy the process group `setup` formed."""
    global _group
    if _group is not None and dist.is_initialized():
        dist.destroy_process_group()
    _group = None


@contextlib.contextmanager
def sharded(group: Group | None):
    """`batch_mean` and `batch_rand` act over `group`'s global batch inside."""
    global _active
    prev, _active = _active, group
    try:
        yield
    finally:
        _active = prev


def all_reduce_mean(tensors: list[torch.Tensor], group: Group) -> list[torch.Tensor]:
    """The mean over the ranks of each tensor, by one all-reduce of one flat
    float32 buffer."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    if group.world > 1:
        flat /= group.world
    out = torch.split(flat, [t.numel() for t in tensors])
    return [o.view(t.shape).to(t.dtype) for o, t in zip(out, tensors)]


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """A mean over this rank's batch -> the mean over the global batch
    (equal batches on every rank), with its gradient, inside `sharded`; `t`
    itself outside."""
    if _active is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t) / _active.world


def batch_rand(shape, generator: torch.Generator | None, device, dtype=None) -> torch.Tensor:
    """`torch.rand(shape)` with the batch first: inside `sharded`, drawn for
    the global batch (world x shape[0] rows) and this rank's rows kept."""
    if _active is None or _active.world == 1:
        return torch.rand(shape, generator=generator, device=device, dtype=dtype)
    B = shape[0]
    u = torch.rand((B * _active.world, *shape[1:]), generator=generator, device=device, dtype=dtype)
    return u[_active.rank * B:(_active.rank + 1) * B]


def batch_shard() -> tuple[int, int]:
    """(rank, world) of the batch inside `sharded`; (0, 1) outside."""
    return (0, 1) if _active is None else (_active.rank, _active.world)


def gather_rank_major(obj) -> list:
    """Every rank's `obj` (any picklable), in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out

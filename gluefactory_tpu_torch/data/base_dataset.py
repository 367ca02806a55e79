"""Dataset base class and loader (counterpart of
`gluefactory_tpu/data/base_dataset.py`).

Datasets run on the host in the loader's workers and emit nested dicts of
numpy arrays with static shapes per split. `collate` stacks them into torch
tensors, which the loader pins when the batches go to a CUDA device, so
that `prepare_batch` copies them there without blocking the host, and turns
`camera` dicts into `Camera` and `T_*` matrices into `Pose` there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils.data as torch_data

from ..core.config import Config, merge
from ..geometry.wrappers import Camera, Pose
from ..utils.tensor import batch_to_device


def collate(batch: list):
    """Stack nested dicts of numpy arrays into tensors: float scalars as
    float32, ints (Python bools among them) as int64, numpy bools as bool;
    lists for strings and objects."""
    elem = batch[0]
    if isinstance(elem, dict):
        return {k: collate([b[k] for b in batch]) for k in elem}
    if isinstance(elem, np.ndarray):
        return torch.from_numpy(np.stack(batch, axis=0))
    if isinstance(elem, (float, np.floating)):
        return torch.as_tensor(np.asarray(batch, dtype=np.float32))
    if isinstance(elem, (int, np.integer)):
        return torch.as_tensor(np.asarray(batch, dtype=np.int64))
    if isinstance(elem, np.bool_):
        return torch.as_tensor(np.asarray(batch, dtype=bool))
    return list(batch)


def prepare_batch(batch, device):
    """A collated batch on `device` (non-blocking from pinned memory), with
    every `camera` dict as a `Camera` and every `T_*` matrix (..., 4, 4) as
    a float32 `Pose`."""

    def convert(key, value):
        if isinstance(value, dict):
            if key == "camera":
                return Camera(value["size"], value["f"], value["c"], value.get("dist"))
            return {k: convert(k, v) for k, v in value.items()}
        if isinstance(key, str) and key.startswith("T_") and torch.is_tensor(value):
            return Pose.from_4x4mat(value.to(torch.float32))
        return value

    return {k: convert(k, v) for k, v in batch_to_device(batch, device).items()}


class LoopSampler(torch_data.Sampler):
    """The first `loop_size` indices, looped up to `total_size` (overfit mode)."""

    def __init__(self, loop_size: int, total_size: int | None = None):
        self.loop_size = loop_size
        self.total_size = total_size - (total_size % loop_size) if total_size else None

    def __iter__(self):
        return (i % self.loop_size for i in range(self.total_size))

    def __len__(self):
        return self.total_size


def worker_init_fn(i):
    info = torch_data.get_worker_info()
    seed = info.dataset.conf.get("seed", 0) if hasattr(info.dataset, "conf") else 0
    np.random.seed(seed + i)


class BaseDataset:
    """Subclasses define `default_conf`, `_init(conf)` and `get_dataset(split)`
    returning a map-style dataset (len + getitem -> nested numpy dict)."""

    base_default_conf = {
        "name": None,
        "num_workers": 0,
        "train_batch_size": None,
        "val_batch_size": None,
        "test_batch_size": None,
        "batch_size": 1,
        "shuffle_training": True,
        "batch_size_divisor": None,
        "prefetch_factor": 2,
        "seed": 0,
    }
    default_conf: dict = {}
    strict_conf = False

    def __init__(self, conf=None):
        defaults = merge(Config(self.base_default_conf), self.default_conf)
        self.conf = merge(defaults, conf or {}, strict=self.strict_conf)
        self._init(self.conf)

    def _init(self, conf):
        pass

    def get_dataset(self, split: str):
        raise NotImplementedError

    def batch_size(self, split: str) -> int:
        return self.conf.get(f"{split}_batch_size") or self.conf.batch_size

    def get_data_loader(self, split: str, shuffle: bool | None = None, distributed: bool = False,
                        pin_memory: bool = False):
        """The split's loader: shuffled from a generator seeded with
        `conf.seed` for training (the JAX package's order), the last partial
        training batch dropped. `pin_memory` for batches bound to a CUDA
        device. `distributed`: this process's shard of the initialised
        process group, through a `DistributedSampler` seeded with
        `conf.seed` (`set_epoch` reshuffles; `drop_last` on the training
        split keeps the shards disjoint, the other splits pad the last
        shard with repeated items), `batch_size` items a process."""
        dataset = self.get_dataset(split)
        if shuffle is None:
            shuffle = split == "train" and self.conf.shuffle_training
        kwargs = {}
        if self.conf.num_workers > 0:
            kwargs["prefetch_factor"] = self.conf.prefetch_factor
            kwargs["worker_init_fn"] = worker_init_fn
        generator = torch.Generator()
        generator.manual_seed(self.conf.seed)
        if distributed:
            import torch.distributed as dist

            kwargs["sampler"] = torch_data.distributed.DistributedSampler(
                dataset, num_replicas=dist.get_world_size(), rank=dist.get_rank(), shuffle=shuffle,
                seed=self.conf.seed, drop_last=split == "train")
            shuffle = False
        return torch_data.DataLoader(
            dataset, batch_size=self.batch_size(split), shuffle=shuffle,
            num_workers=self.conf.num_workers, collate_fn=collate, drop_last=split == "train",
            generator=generator, pin_memory=pin_memory, **kwargs,
        )

    def get_overfit_loader(self, split: str, pin_memory: bool = False):
        """One batch of the training set, looped."""
        dataset = self.get_dataset("train")
        sampler = LoopSampler(self.batch_size(split),
                              len(dataset) if split == "train" else self.batch_size(split))
        return torch_data.DataLoader(dataset, batch_size=self.batch_size(split), sampler=sampler,
                                     num_workers=0, collate_fn=collate, pin_memory=pin_memory)

"""Data loading: the port of ``deepspeed_tpu/runtime/dataloader.py``.

``DeepSpeedDataLoader`` yields micro-batches (numpy pytrees) from an
indexable dataset in a seeded order, and records its position so that a
fresh loader over the same dataset resumes the exact batch sequence. With a
``rank`` and ``world_size`` it is a distributed sampler: step i's global
micro-batch is the next ``batch_size * world_size`` samples of the order,
and each rank yields its contiguous ``batch_size`` of them, the slice
``train_batch`` takes of a global batch;
``RepeatingLoader`` restarts an iterator at its end. The engine moves each
batch to its device in ``train_batch``. The JAX module's curriculum hooks
(``curriculum_fn``, the data-pipeline ``sampler``) and its device-prefetch
wrapper are not ported: ``data_efficiency`` raises in the engine (ROADMAP.md
Queue A item 10).
"""

from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np


class RepeatingLoader:
    """Wrap an iterable to restart on StopIteration (reference ``:17``)."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:
    """Batch loader over an indexable dataset of pytrees. Epoch ``e`` visits
    the samples in the order ``numpy.random.default_rng(seed + e)`` shuffles
    them to (the JAX package's order, so both packages see the same
    batches)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 collate_fn: Optional[Callable] = None, drop_last: bool = True,
                 rank: int = 0, world_size: int = 1):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a world of {world_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.collate_fn = collate_fn or _default_collate
        self.drop_last = drop_last
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0
        self.global_step = 0
        self.batch_in_epoch = 0   # batches yielded in the current epoch
        self._resume_offset = 0   # batches to skip on the next __iter__
        n = len(dataset)
        step = batch_size * world_size
        self.len = n // step if drop_last else (n + step - 1) // step

    def __len__(self):
        return self.len

    def state_dict(self) -> dict:
        """The loader's position: restored into a fresh loader over the same
        dataset and seed, iteration goes on with the batch an uninterrupted
        run would have yielded next."""
        return {"epoch": self.epoch, "batch_in_epoch": self.batch_in_epoch,
                "seed": self.seed, "global_step": self.global_step}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.seed = int(state.get("seed", self.seed))
        self.global_step = int(state.get("global_step", 0))
        self.batch_in_epoch = 0
        self._resume_offset = int(state.get("batch_in_epoch", 0))

    def __iter__(self) -> Iterator[Any]:
        start, self._resume_offset = self._resume_offset, 0
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.batch_in_epoch = start
        step = self.batch_size * self.world_size
        for i in range(start, self.len):
            idx = order[i * step:(i + 1) * step][self.rank * self.batch_size:
                                                 (self.rank + 1) * self.batch_size]
            batch = self.collate_fn([self.dataset[int(j)] for j in idx])
            self.global_step += 1
            self.batch_in_epoch = i + 1
            yield batch
        self.epoch += 1
        self.batch_in_epoch = 0


def _default_collate(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: np.stack([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([it[i] for it in items]) for i in range(len(first)))
    return np.stack(items)

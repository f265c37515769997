"""Data loading: the port of ``deepspeed_tpu/runtime/dataloader.py``.

``DeepSpeedDataLoader`` yields micro-batches (numpy pytrees) from an
indexable dataset in a seeded order, and records its position so that a
fresh loader over the same dataset resumes the exact batch sequence. With a
``rank`` and ``world_size`` it is a distributed sampler: step i's global
micro-batch is the next ``batch_size * world_size`` samples of the order,
and each rank yields its contiguous ``batch_size`` of them, the slice
``train_batch`` takes of a global batch;
``RepeatingLoader`` restarts an iterator at its end. The engine moves each
batch to its device in ``train_batch``, or takes it as it is when
``PrefetchLoader`` has put it there already: that wrapper keeps ``depth``
batches in flight, copied from pinned host buffers to the card on a side
stream. The JAX module's curriculum hooks (``curriculum_fn``, the
data-pipeline ``sampler``) are not ported: ``data_efficiency`` raises in
the engine (ROADMAP.md Queue A item 10).
"""

import collections
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree


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


class PrefetchLoader:
    """Device prefetch over any batch iterator (JAX ``PrefetchLoader``; the
    reference loader's pinned memory and worker prefetch): while step t
    computes, the next ``depth`` batches are already on their way to the
    device.

    ``sharding`` is the target ``torch.device`` (the port's one device per
    rank takes the place of a JAX sharding); it defaults to the card and
    raises where there is none, and the CPU is used only when asked for
    (the leaves then become tensors without a transfer). On the card each
    leaf is copied into a pinned host buffer from a small pool, then to the
    device on a side stream; a buffer is reused only once the event of the
    copy that last read it has completed (with more than ``depth`` buffers
    of a shape pooled, a new leaf waits for the oldest). A yielded batch's
    tensors are ready on the consumer's current stream: it waits on the
    copy's event, and each tensor is marked used there (``record_stream``).

    Re-iteration and ``len()`` follow the wrapped loader; ``state_dict``
    rolls the wrapped loader's position back by the batches in flight."""

    def __init__(self, loader: Iterable, sharding=None, depth: int = 2):
        from ..accelerator import resolve_device

        self.loader = loader
        self.sharding = resolve_device("cuda" if sharding is None else sharding)
        self.depth = max(1, int(depth))
        self._inflight = 0  # batches drawn from the wrapped loader, not yet yielded
        self._stream = None
        # (shape, dtype) -> (pinned buffer, its last copy's event), oldest first
        self._pool = collections.defaultdict(collections.deque)

    def state_dict(self) -> dict:
        """The wrapped loader's state at the consumed position: batches in
        the prefetch queue were drawn but never reached the trainer, so its
        position goes back by the in-flight count (across an epoch boundary
        when needed)."""
        inner = getattr(self.loader, "state_dict", None)
        if inner is None:
            raise TypeError("PrefetchLoader wraps a loader without "
                            "state_dict(); wrap a DeepSpeedDataLoader for "
                            "resumable iteration")
        state = dict(inner())
        bi = int(state.get("batch_in_epoch", 0)) - self._inflight
        gs = int(state.get("global_step", 0)) - self._inflight
        if bi < 0:
            state["epoch"] = int(state["epoch"]) - 1
            bi += len(self.loader)
        state["batch_in_epoch"] = bi
        state["global_step"] = max(0, gs)
        return state

    def load_state_dict(self, state: dict) -> None:
        self.loader.load_state_dict(state)
        self._inflight = 0

    def _pinned(self, x: torch.Tensor) -> torch.Tensor:
        """A pinned buffer shaped like ``x``: the pool's oldest once the copy
        that read it has completed (waited for when the pool holds more
        than ``depth`` of the shape), else a new one."""
        pool = self._pool[(tuple(x.shape), x.dtype)]
        if pool and (len(pool) > self.depth or pool[0][1].query()):
            buf, event = pool.popleft()
            event.synchronize()
            return buf
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)

    def _put(self, batch):
        """Start the batch's transfer; returns (its device tree, the event
        the consumer waits on, or None on the CPU)."""
        if self.sharding.type == "cpu":
            return pytree.tree_map(torch.as_tensor, batch), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.sharding)
        leaves, spec = pytree.tree_flatten(batch)
        host = []
        for x in leaves:
            x = torch.as_tensor(x)
            host.append(self._pinned(x).copy_(x))
        with torch.cuda.stream(self._stream):
            out = [h.to(self.sharding, non_blocking=True) for h in host]
            event = torch.cuda.Event()
            event.record(self._stream)
        for h in host:
            self._pool[(tuple(h.shape), h.dtype)].append((h, event))
        return pytree.tree_unflatten(out, spec), event

    def _ready(self, item):
        tree, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.sharding)
            stream.wait_event(event)
            for t in pytree.tree_leaves(tree):
                t.record_stream(stream)
        return tree

    def __iter__(self):
        queue = collections.deque()
        it = iter(self.loader)
        self._inflight = 0
        try:
            for _ in range(self.depth):
                queue.append(self._put(next(it)))
                self._inflight += 1
        except StopIteration:
            pass
        while queue:
            out = queue.popleft()
            try:
                queue.append(self._put(next(it)))
                self._inflight += 1
            except StopIteration:
                pass
            self._inflight -= 1
            yield self._ready(out)

    def __len__(self):
        try:
            return len(self.loader)
        except TypeError:
            raise TypeError("PrefetchLoader wraps an unsized iterator; "
                            "wrap a sized loader (list, DeepSpeedDataLoader) "
                            "if len() is needed") from None


def _default_collate(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: np.stack([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([it[i] for it in items]) for i in range(len(first)))
    return np.stack(items)

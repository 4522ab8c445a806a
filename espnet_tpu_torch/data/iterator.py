"""Epoch-reproducible batch iteration (counterpart of
espnet_tpu/data/iterator.py:SequenceIterFactory): the batch order of
epoch e is shuffled by numpy's RandomState(seed + e), so a resumed run
sees the batches an uninterrupted one would; ``num_iters_per_epoch``
cycles through the shuffled batches so that each epoch takes its own
slice. A thread collates the next batches while the card computes."""

from __future__ import annotations

import threading
from queue import Queue
from typing import Callable, Optional, Sequence, Tuple

import numpy as np


class SequenceIterFactory:
    def __init__(self, dataset, batches: Sequence[Tuple[str, ...]],
                 collate_fn: Callable, seed: int = 0, shuffle: bool = True,
                 num_iters_per_epoch: Optional[int] = None):
        self.dataset = dataset
        self.batches = list(batches)
        self.collate_fn = collate_fn
        self.seed = seed
        self.shuffle = shuffle
        self.num_iters_per_epoch = num_iters_per_epoch

    def epoch_batches(self, epoch: int, shuffle: Optional[bool] = None):
        """The key tuples of epoch ``epoch``, in order."""
        batches = list(self.batches)
        if self.shuffle if shuffle is None else shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(batches)
        if self.num_iters_per_epoch is not None:
            n = self.num_iters_per_epoch
            start = (n * (epoch - 1)) % max(len(batches), 1)
            batches = (batches * ((n + len(batches) - 1) // len(batches)
                                  + 1))[start:start + n]
        return batches

    def build_iter(self, epoch: int, shuffle: Optional[bool] = None):
        """Yields (uids, collated numpy batch); the dataset learns the
        epoch (a preprocessor's random crops draw per epoch)."""
        self.dataset.epoch = epoch
        return prefetch(
            self.collate_fn([self.dataset[k] for k in keys])
            for keys in self.epoch_batches(epoch, shuffle))


def prefetch(iterator, depth: int = 2):
    """Run ``iterator`` in a thread ``depth`` items ahead; an exception
    there is raised here."""
    q: Queue = Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item

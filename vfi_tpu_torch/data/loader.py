"""Threaded, prefetching batch loader, the port of `vfi_tpu/data/loader.py`.

Items load on a thread pool and finished batches wait in a bounded queue,
`prefetch` deep, so host data work overlaps the card's steps. The threads
touch only numpy: every tensor and all autograd work stay on the
consumer's thread.

Determinism: item k of an epoch draws from
`np.random.Generator(Philox(key=[seed, epoch << 32 | k]))` and the epoch's
order from the key `[seed, epoch << 32 | 0xFFFFFFFF]`, so for a seed and
an epoch the batches are those of the JAX loader on the same directory,
whatever the threads' timing.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from vfi_tpu_torch.data.dataset import TripletDataset


class DataLoader:
    """Iterable over one epoch of batched triplets a pass: (frame0,
    frame_t, frame1), each (B, H, W, 3) float32. `drop_last` drops the
    last incomplete batch; `epoch` advances after each pass."""

    def __init__(self, dataset: TripletDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, num_threads: int = 4,
                 prefetch: int = 2, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _item_rng(self, index: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(
            key=[self.seed, (self.epoch << 32) + index]))

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.Generator(np.random.Philox(
                key=[self.seed, (self.epoch << 32) + 0xFFFFFFFF])).shuffle(
                    order)
        return order

    def __iter__(self) -> Iterator[tuple]:
        order = self._epoch_order()
        nb = len(self)
        out_q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def load_item(args):
            pos, idx = args
            return self.dataset.get(int(idx), self._item_rng(pos))

        def put(item) -> bool:
            """Queue `item` unless the consumer has gone."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        sel = order[b * self.batch_size:
                                    (b + 1) * self.batch_size]
                        items = list(pool.map(load_item, [
                            (b * self.batch_size + k, idx)
                            for k, idx in enumerate(sel)]))
                        batch = tuple(np.stack([it[j] for it in items])
                                      for j in range(3))
                        if not put(batch):
                            return
                put(None)
            except BaseException as e:  # surface loader errors
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()
            self.epoch += 1

"""Batched, prefetching data loader, port of ``sdface_gan_tpu/data/loader.py``.

Epoch shuffling from ``default_rng(seed + epoch)``, drop-last batching,
this host's slice of each global batch, flips from one
``default_rng(seed)`` stream, and a background thread that keeps
``prefetch`` batches decoded ahead of the card.  Batches are numpy
``(imgs [B, H, W, 3], thumbs [B, h, w, 3])``, which the training loops take.

Lifecycle: the worker never blocks for good on a full queue (it re-checks
its stop flag between timed puts), a worker that dies raises at the
consumer, and :meth:`close` (or the context manager, or the generator's
finalizer) stops and joins every worker before returning, so no thread
touches the dataset after the caller closes it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np

from .dataset import MultiResolutionDataset


class DataLoader:
    def __init__(
        self,
        dataset: MultiResolutionDataset,
        batch_size: int,
        seed: int = 0,
        prefetch: int = 4,
        host_id: int = 0,
        num_hosts: int = 1,
    ):
        """``batch_size`` is the global batch: every host draws the same
        epoch permutation and yields its ``batch_size // num_hosts`` slice
        of each global batch.  Every epoch is shuffled and its last partial
        batch dropped (the JAX loader's defaults, which every caller uses)."""
        if batch_size % num_hosts != 0:
            raise ValueError(
                f"global batch {batch_size} must divide across {num_hosts} hosts"
            )
        if not (0 <= host_id < num_hosts):
            raise ValueError(f"host_id {host_id} out of range [0, {num_hosts})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.prefetch = prefetch
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._workers: List[Tuple[threading.Event, threading.Thread]] = []
        self._lock = threading.Lock()

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite iterator over (imgs, thumbs) batches."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        _DEAD = object()  # sentinel: worker exited, nothing more will come

        def put_bounded(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            epoch = 0
            rng = np.random.default_rng(self.seed)
            per_host = self.batch_size // self.num_hosts
            try:
                while not stop.is_set():
                    order = self._epoch_indices(epoch)
                    for b in range(len(order) // self.batch_size):
                        if stop.is_set():
                            return
                        sel = order[b * self.batch_size:(b + 1) * self.batch_size]
                        sel = sel[self.host_id * per_host:(self.host_id + 1) * per_host]
                        imgs, thumbs = zip(
                            *(self.dataset.__getitem__(int(i), rng) for i in sel)
                        )
                        put_bounded((np.stack(imgs), np.stack(thumbs)))
                    epoch += 1
            except BaseException as e:  # handed to the consumer, which re-raises
                # a silent worker death would leave the consumer in q.get() for good
                put_bounded((_DEAD, e))
            else:
                put_bounded((_DEAD, None))

        t = threading.Thread(target=worker, daemon=True)
        with self._lock:
            self._workers.append((stop, t))
        t.start()
        try:
            while True:
                item = q.get()
                if item[0] is _DEAD:
                    if item[1] is not None:
                        raise RuntimeError("DataLoader worker died") from item[1]
                    return
                yield item
        finally:
            stop.set()
            while True:  # unblock a worker stuck in q.put, then join it
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10.0)
            with self._lock:
                self._workers = [w for w in self._workers if w[1] is not t]

    def close(self) -> None:
        """Stop and join every live worker thread; after this returns the
        caller may close the dataset.  Idempotent."""
        with self._lock:
            workers, self._workers = self._workers, []
        for stop, _ in workers:
            stop.set()
        for _, t in workers:
            t.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

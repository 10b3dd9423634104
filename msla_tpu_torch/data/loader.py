"""Batcher of numpy frames (the port's copy of msla_tpu/data/loader.py;
reference: torch's DataLoader in src/data/datamodule.py:76-110).

Dataset frames are views into the cached tracks in host memory, so a batch is
one stack of views: no worker processes. With ``num_workers > 0`` a background
thread assembles the next batch while the current one is consumed. The batches
are numpy arrays; the Trainer copies them to the card one step ahead.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 0, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        """`process_index`/`process_count`: multi-host interleave (the torch
        DistributedSampler role). Every rank draws the SAME epoch permutation
        (shared seed, rank-independent rng consumption) and takes the strided
        slice `order[process_index::process_count]` after wrap-padding the
        order to a multiple of process_count — so all ranks yield the SAME
        number of equally-sized batches (collective lockstep) of DISJOINT
        examples (up to ≤process_count-1 wrapped duplicates per epoch).
        `batch_size` stays the PER-PROCESS batch: `shard_batch` assembles the
        global batch from these local shards, so the effective global batch is
        batch_size × process_count (torch-DDP semantics)."""
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = int(num_workers)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"process_index {process_index} outside "
                             f"process_count {process_count}")
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def _local_len(self) -> int:
        """Per-rank example count: ceil(n / process_count), identical on every
        rank (wrap-padded)."""
        n = len(self.dataset)
        if self.process_count == 1:
            return n
        return -(-n // self.process_count)

    def __len__(self) -> int:
        n = self._local_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> list[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        if self.process_count > 1:
            total = self._local_len() * self.process_count
            if total > len(order):  # wrap-pad so every rank gets equal length
                # tile, don't slice once: a dataset SMALLER than the process
                # count needs more than one wrap, and a short pad would starve
                # trailing ranks of batches — they would never enter the
                # collective the fed ranks are blocked in (lockstep hang)
                order = np.tile(order, -(-total // len(order)))[:total]
            order = order[self.process_index::self.process_count]
        batches = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                continue
            batches.append(idx)
        return batches

    def _assemble(self, idx: np.ndarray) -> np.ndarray:
        return np.stack([self.dataset[int(i)] for i in idx])

    def __iter__(self) -> Iterator[np.ndarray]:
        self._epoch += 1
        batches = self._batch_indices()
        if self.num_workers <= 0:
            for idx in batches:
                yield self._assemble(idx)
            return

        q: queue.Queue = queue.Queue(maxsize=2)
        done = object()
        abandoned = threading.Event()

        def producer():
            for idx in batches:
                item = self._assemble(idx)
                # bounded put that notices an abandoned consumer (e.g. a
                # fast_dev_run or limit_*_batches break) — otherwise the
                # thread would block on the full queue forever
                while not abandoned.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if abandoned.is_set():
                    return
            q.put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                yield item
        finally:
            abandoned.set()
            thread.join(timeout=5)

"""Threaded prefetching batch loader (the port's own copy of
``ccvs_tpu/data/loader.py``).

A thread pool decodes/augments samples on host CPU while the device
computes, and a small prefetch queue keeps batches ready.
"""

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

from ccvs_tpu_torch.data.base import group_collate


def host_shard_spec():
    """(rank, world size) of an initialised ``torch.distributed`` process
    group of more than one process, else None: each process loads only its
    stride of the global index (the reference's DistributedSampler split,
    `tools/engine.py:81-101`)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return None
    return dist.get_rank(), dist.get_world_size()


class PrefetchLoader:
    """``batch_size`` is the GLOBAL batch; under multi-host each process
    loads ``batch_size / n_hosts`` samples of it (disjoint by index stride,
    deterministic: every host shuffles the full index with the same
    seed+epoch before taking its stride)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, prefetch: int = 2, drop_last: bool = True,
                 collate: Callable = group_collate, seed: int = 0,
                 host_shard="auto"):
        self.dataset = dataset
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.collate = collate
        self.seed = seed
        self.epoch = 0
        self.host_shard = host_shard_spec() if host_shard == "auto" else host_shard
        if self.host_shard is not None:
            hid, nh = self.host_shard
            if batch_size % nh:
                raise ValueError(f"global batch {batch_size} not divisible by "
                                 f"{nh} hosts")
            self.batch_size = batch_size // nh
        else:
            self.batch_size = batch_size

    def __len__(self):
        n = len(self.dataset)
        if self.host_shard is not None:
            # Every host must yield the SAME batch count: put_batch is a
            # cross-process collective, so a short shard on one host would
            # deadlock the others (the reference's DistributedSampler pads
            # shards equal for the same reason, `tools/engine.py:87`).
            _, nh = self.host_shard
            n = -(-n // nh)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_order(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.host_shard is not None:
            hid, nh = self.host_shard
            pad = (-len(idx)) % nh
            if pad:  # wraparound padding -> equal-length per-host shards
                idx = np.concatenate([idx, idx[:pad]])
            idx = idx[hid::nh]
        return idx

    def __iter__(self) -> Iterator[dict]:
        idx = self._index_order()
        self.epoch += 1
        nb = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
                        items = list(pool.map(self.dataset.__getitem__, sel))
                        q.put(self.collate(items))
                q.put(None)
            except BaseException as e:  # noqa: BLE001 — propagate to consumer
                # Without this the consumer blocks on q.get() forever when a
                # worker raises (torch DataLoader re-raises in the main
                # process too).
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()


def infinite(loader: PrefetchLoader) -> Iterator[dict]:
    while True:
        yield from loader


class FoldCycler:
    """Cycle through dataset folds, exhausting one fold's loader before
    building the next (reference `frame_autoencoder_trainer.next_batch`,
    `helpers/frame_autoencoder_trainer.py:23-44`: folds keep host memory
    bounded for datasets too large to index at once)."""

    def __init__(self, make_loader: Callable[[int], "PrefetchLoader"],
                 num_folds: int, init_fold: int = 0, random_fold: bool = False,
                 seed: int = 0):
        self.make_loader = make_loader
        self.num_folds = num_folds
        self.fold = init_fold
        # reference --random_fold_train (set by every shipped kinetics
        # script): pick a random fold per cycle instead of round-robin
        # (`helpers/frame_autoencoder_trainer.py:108`)
        self.random_fold = random_fold
        self._rng = random.Random(seed)

    def __iter__(self):
        while True:
            loader = self.make_loader(self.fold)
            yield from loader
            self.fold = (self._rng.randrange(self.num_folds) if self.random_fold
                         else (self.fold + 1) % self.num_folds)

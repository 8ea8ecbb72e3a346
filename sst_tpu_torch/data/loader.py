"""Threaded prefetching data loader (the port's copy of
``sst_tpu/data/loader.py``): the index order of JAX's loader for every
seed, epoch, shard and ``drop_last``, and its worker threads.

Worker threads, not ``torch.utils.data.DataLoader`` worker processes: a
``Custom3DDataset`` hands every sample one shared ``RandomState``, which a
worker process would copy, so each process would repeat the others' draws.
Batches are collated on the CPU (``data/datasets.py collate_to_batch``);
the caller moves each to the device on its own thread. With
``num_shards > 1`` (one process per card: ``num_shards=world``,
``shard_id=rank``) each process iterates a disjoint slice of the epoch.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Sequence

import numpy as np

from sst_tpu_torch.data.datasets import collate_to_batch


def weak_shuffle_indices(seq_ids: np.ndarray, shard_size: int, seed: int,
                         epoch: int, num_shards: int = 1,
                         shard_id: int = 0) -> np.ndarray:
    """Sequence-shard-aware shuffle (reference DistributedSampler weak_shuffle,
    apis/samplers.py:35-100 get_seq_shard_indices): indices are grouped into
    contiguous shards of one sequence each (capped at shard_size), shard
    ORDER is shuffled but intra-shard time order is preserved — FSD++/CTRL
    need temporally ordered neighbors while still mixing sequences.

    With num_shards > 1 (multi-host), WHOLE sequence-shards are dealt
    round-robin over processes after the seeded shuffle, so every process
    keeps temporally contiguous runs (the reference's per-rank seq-shard
    assignment, apis/samplers.py:59)."""
    seq_ids = np.asarray(seq_ids)
    n = len(seq_ids)
    shards = []
    start = 0
    for i in range(1, n + 1):
        boundary = i == n or seq_ids[i] != seq_ids[start]
        if boundary or (i - start) >= shard_size:
            shards.append(np.arange(start, i))
            start = i
    rng = np.random.RandomState(seed + epoch)
    order = rng.permutation(len(shards))
    if num_shards > 1:
        order = order[shard_id::num_shards]
    return np.concatenate([shards[o] for o in order]) if len(order) else \
        np.zeros((0,), np.int64)


def sequential_lane_indices(seq_ids: np.ndarray, num_lanes: int) -> list:
    """Whole sequences per lane in time order
    (WaymoSequentialDistributedSampler, build_dataloader_sequential.py:15-60):
    returns per-lane index lists; lane l at step t processes its own
    sequences strictly in temporal order (FSD++ sequential testing)."""
    seq_ids = np.asarray(seq_ids)
    uniq = []
    for s in seq_ids:
        if not uniq or uniq[-1] != s:
            uniq.append(s)
    lanes: list = [[] for _ in range(num_lanes)]
    sizes = [0] * num_lanes
    for s in uniq:
        idx = np.nonzero(seq_ids == s)[0]
        l = int(np.argmin(sizes))
        lanes[l].extend(idx.tolist())
        sizes[l] += len(idx)
    return lanes


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, seed: int = 0, drop_last: bool = True,
                 collate: Callable = collate_to_batch,
                 weak_shuffle_seq_ids: Sequence | None = None,
                 weak_shuffle_shard_size: int = 20,
                 num_shards: int = 1, shard_id: int = 0):
        """batch_size is PER PROCESS. With num_shards > 1 (data-parallel
        training: num_shards=world size, shard_id=rank), each process
        iterates a disjoint slice of the epoch — the reference's
        DistributedSampler (apis/samplers.py:13: stride rank::world after the
        seeded shuffle; weak_shuffle variant keeps whole sequence-shards per
        rank, :59 get_seq_shard_indices)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.collate = collate
        self.weak_shuffle_seq_ids = weak_shuffle_seq_ids
        self.weak_shuffle_shard_size = weak_shuffle_shard_size
        assert 0 <= shard_id < num_shards
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.epoch = 0

    def _indices(self):
        n = len(self.dataset)
        if self.weak_shuffle_seq_ids is not None and self.shuffle:
            idx = weak_shuffle_indices(
                self.weak_shuffle_seq_ids, self.weak_shuffle_shard_size,
                self.seed, self.epoch,
                num_shards=self.num_shards, shard_id=self.shard_id,
            )
        else:
            idx = np.arange(n)
            if self.shuffle:
                np.random.RandomState(self.seed + self.epoch).shuffle(idx)
            if self.num_shards > 1:
                # same-seed global order on every process, disjoint stride
                # per process (reference DistributedSampler semantics)
                idx = idx[self.shard_id::self.num_shards]
        if self.drop_last:
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        return idx

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        idx = self._indices()
        batches = [
            idx[i : i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        q: queue.Queue = queue.Queue(maxsize=self.num_workers * 2)
        stop = threading.Event()

        def worker(batch_list):
            for b in batch_list:
                if stop.is_set():
                    return
                samples = [self.dataset[int(i)] for i in b]
                q.put(self.collate(samples))
            q.put(None)

        shards = [batches[i :: self.num_workers] for i in range(self.num_workers)]
        threads = [
            threading.Thread(target=worker, args=(s,), daemon=True)
            for s in shards
        ]
        for t in threads:
            t.start()
        done = 0
        try:
            while done < self.num_workers:
                item = q.get()
                if item is None:
                    done += 1
                    continue
                yield item
        finally:
            stop.set()
        self.epoch += 1

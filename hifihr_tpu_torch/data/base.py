"""Host-side batching (counterpart of hifihr_tpu/data/base.py): the dataset
protocol, `collate`, `Subset`, `BatchLoader` and `ConcatLoader`.

Datasets are query-driven samplers returning numpy dicts, and a loader
yields numpy batches, exactly as the JAX package's do: the same shuffle
seeds, drop-last, thread pool, prefetch window and corrupt-sample
substitution, so both packages see the same batches in the same order.
`data/pipeline.py::prefetch_to_device` moves them to the card.
"""

from __future__ import annotations

import itertools
import logging
import warnings
from typing import Iterator, Protocol, Sequence

import numpy as np


class HandDataset(Protocol):
    name: str

    def __len__(self) -> int: ...

    def get_sample(self, idx: int) -> dict: ...


def collate(samples: Sequence[dict]) -> dict:
    """Stack a list of numpy sample dicts into one batch dict."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = vals
    return out


class Subset:
    """First-k view of any HandDataset: the reference's controlled-size
    experiments wrap every pose dataset this way (data/dataset.py:97-106)."""

    def __init__(self, dataset, size: int):
        n = len(dataset)
        if n < size:
            warnings.warn(f"limit size {size} > dataset size {n}; using full dataset")
        self.dataset = dataset
        self.size = min(int(size), n)
        self.name = getattr(dataset, "name", "unknown")

    def __len__(self) -> int:
        return self.size

    def get_sample(self, idx: int) -> dict:
        return self.dataset.get_sample(idx)


class BatchLoader:
    """Shuffling, drop-last batch iterator with a deterministic seed: epoch e
    (counted by `__iter__` calls) shuffles with RandomState(seed + e).

    `num_workers > 0` fetches samples through a thread pool with a
    `prefetch_batches`-deep lookahead window, as the JAX package's loader
    does (the per-sample work of its real-data loaders releases the GIL).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, num_workers: int = 0,
                 prefetch_batches: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch_batches = prefetch_batches
        self.epoch = 0
        self._pool = None

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _fetch(self, i: int, substitute_idx: int) -> dict:
        # corrupt-sample fault tolerance: substitute a deterministic random
        # sample (reference data/dataset.py:1391-1399), and log it
        try:
            return self.dataset.get_sample(int(i))
        except Exception as exc:  # noqa: BLE001 - any sample fault is substituted
            logging.warning("sample %d failed (%s); substituting", i, exc)
            return self.dataset.get_sample(int(substitute_idx))

    def _batch_starts(self, n: int):
        return range(0, n - self.batch_size + 1 if self.drop_last else n,
                     self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        rng = np.random.RandomState(self.seed + self.epoch + 12345)
        subs = rng.randint(n, size=max(n, 1))  # per-position substitute idxs
        name = getattr(self.dataset, "name", "unknown")

        if self.num_workers <= 0:
            for start in self._batch_starts(n):
                idxs = order[start : start + self.batch_size]
                batch = collate([self._fetch(i, subs[i]) for i in idxs])
                batch["dataset"] = name
                yield batch
            return

        import concurrent.futures

        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(self.num_workers)
        window: list[list] = []
        starts = list(self._batch_starts(n))
        next_b = 0

        def submit_batch():
            nonlocal next_b
            idxs = order[starts[next_b] : starts[next_b] + self.batch_size]
            window.append([self._pool.submit(self._fetch, i, subs[i]) for i in idxs])
            next_b += 1

        while next_b < len(starts) and next_b <= self.prefetch_batches:
            submit_batch()
        while window:
            futs = window.pop(0)
            if next_b < len(starts):
                submit_batch()
            batch = collate([f.result() for f in futs])
            batch["dataset"] = name
            yield batch


class ConcatLoader:
    """Round-robin over several loaders (reference ConcatDataloader,
    utils/concat_dataloader.py:9-37): len is the sum of the members'; each
    batch comes from one dataset (tagged with its name), the next from the
    next loader, and an exhausted member restarts."""

    def __init__(self, loaders: Sequence[BatchLoader]):
        self.loaders = list(loaders)

    def __len__(self) -> int:
        return sum(len(l) for l in self.loaders)

    def __iter__(self) -> Iterator[dict]:
        iters = [iter(l) for l in self.loaders]
        cycle = itertools.cycle(range(len(iters)))
        remaining = len(self)
        while remaining > 0:
            i = next(cycle)
            try:
                yield next(iters[i])
                remaining -= 1
            except StopIteration:
                iters[i] = iter(self.loaders[i])

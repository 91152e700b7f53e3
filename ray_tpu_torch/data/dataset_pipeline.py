"""DatasetPipeline: windowed / repeated streaming over a Dataset.

Analog of the reference's python/ray/data/dataset_pipeline.py: a pipeline is
a sequence of Dataset *windows* executed lazily, so transforms on a window
overlap with consumption of the previous one; ``repeat`` provides per-epoch
iteration for training ingest.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data.dataset import Dataset


class DatasetPipeline:
    def __init__(self, window_factories: List[Callable[[], Dataset]],
                 length: Optional[int] = None):
        self._factories = window_factories
        self._length = length if length is not None else len(window_factories)
        self._stages: List[Callable[[Dataset], Dataset]] = []

    @staticmethod
    def from_dataset(ds: Dataset, blocks_per_window: int) -> "DatasetPipeline":
        blocks, metas = ds._execute()
        factories = []
        for i in range(0, len(blocks), blocks_per_window):
            b = blocks[i:i + blocks_per_window]
            m = metas[i:i + blocks_per_window]
            factories.append(lambda b=b, m=m: Dataset.from_blocks(b, m))
        return DatasetPipeline(factories)

    @staticmethod
    def from_dataset_repeated(ds: Dataset, times: Optional[int]
                              ) -> "DatasetPipeline":
        n = times if times is not None else 1_000_000_000
        blocks, metas = ds._execute()
        factories = [lambda e=e: Dataset.from_blocks(blocks, metas)
                     for e in range(min(n, 10**6))]
        return DatasetPipeline(factories, length=n)

    def _wrap(self, stage: Callable[[Dataset], Dataset]) -> "DatasetPipeline":
        p = DatasetPipeline(self._factories, self._length)
        p._stages = self._stages + [stage]
        return p

    def map_batches(self, fn, **kwargs) -> "DatasetPipeline":
        return self._wrap(lambda ds: ds.map_batches(fn, **kwargs))

    def map(self, fn, **kwargs) -> "DatasetPipeline":
        return self._wrap(lambda ds: ds.map(fn, **kwargs))

    def filter(self, fn, **kwargs) -> "DatasetPipeline":
        return self._wrap(lambda ds: ds.filter(fn, **kwargs))

    def random_shuffle_each_window(self, **kwargs) -> "DatasetPipeline":
        return self._wrap(lambda ds: ds.random_shuffle(**kwargs))

    def iter_datasets(self) -> Iterator[Dataset]:
        for factory in self._factories:
            ds = factory()
            for stage in self._stages:
                ds = stage(ds)
            yield ds

    def iter_epochs(self) -> Iterator[Dataset]:
        return self.iter_datasets()

    def iter_rows(self):
        for ds in self.iter_datasets():
            yield from ds.iter_rows()

    def iter_batches(self, **kwargs):
        for ds in self.iter_datasets():
            yield from ds.iter_batches(**kwargs)

    def take(self, n: int = 20):
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def count(self) -> int:
        return sum(ds.count() for ds in self.iter_datasets())

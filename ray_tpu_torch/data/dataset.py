"""Dataset: a distributed collection of blocks with lazy transforms.

Analog of the reference's python/ray/data/dataset.py: blocks live in the
object store as refs; transforms append stages to a lazy ExecutionPlan
(data/_internal/plan.py) which fuses one-to-one stages and runs all-to-all
stages through the push-based shuffle. The default batch format is a
dict of host numpy arrays, and ``iter_torch_batches`` hands a train loop
its shard as tensors on its device.
"""

from __future__ import annotations

import itertools
from typing import (Any, Callable, Dict, Iterator, List, Optional, Tuple,
                    Union)

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import aggregate as agg_mod
from ray_tpu_torch.data._internal.compute import resolve_compute
from ray_tpu_torch.data._internal.plan import (AllToAllStage, ExecutionPlan,
                                         OneToOneStage)
from ray_tpu_torch.data._internal.shuffle import shuffle_blocks, sort_blocks
from ray_tpu_torch.data.block import (VALUE_COL, Block, BlockAccessor,
                                BlockMetadata)

BatchUDF = Callable[[Any], Any]
RowUDF = Callable[[Any], Any]


class Dataset:
    def __init__(self, plan: ExecutionPlan, epoch: int = 0):
        self._plan = plan
        self._epoch = epoch

    # ------------------------------------------------------------------
    # Construction helpers
    # ------------------------------------------------------------------

    @staticmethod
    def from_blocks(blocks: List[Any], metadata: List[BlockMetadata]
                    ) -> "Dataset":
        return Dataset(ExecutionPlan(blocks, metadata))

    def _execute(self) -> Tuple[List[Any], List[BlockMetadata]]:
        return self._plan.execute()

    def get_internal_block_refs(self) -> List[Any]:
        return self._execute()[0]

    def materialize(self) -> "Dataset":
        blocks, metas = self._execute()
        return Dataset.from_blocks(blocks, metas)

    # Alias matching the reference's older API.
    fully_executed = materialize

    # ------------------------------------------------------------------
    # One-to-one transforms
    # ------------------------------------------------------------------

    def map_batches(self, fn: BatchUDF, *, batch_size: Optional[int] = None,
                    batch_format: Optional[str] = "numpy",
                    compute=None, fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None,
                    num_cpus: float = 1.0, zero_copy_batch: bool = False,
                    **_ignored) -> "Dataset":
        """Apply ``fn`` to batches of rows. With a callable class + an
        ActorPoolStrategy, the class is constructed once per pool actor
        (reference: dataset.py map_batches / compute.py)."""
        compute = resolve_compute(compute)
        udf_constructor = None
        if isinstance(fn, type):
            udf_constructor = (fn, fn_constructor_args,
                               fn_constructor_kwargs or {})

            def transform(block, _fmt=batch_format, _bs=batch_size):
                raise RuntimeError("class UDF requires actor compute")

            def actor_transform(block, instance, _fmt=batch_format,
                                _bs=batch_size):
                return _map_batches_block(block, instance, _fmt, _bs)

            from ray_tpu_torch.data._internal.compute import ActorPoolStrategy
            if not isinstance(compute, ActorPoolStrategy):
                raise ValueError(
                    "Callable-class UDFs require compute=ActorPoolStrategy "
                    "(the class is constructed once per pool actor)")
            stage = OneToOneStage(
                name="map_batches", transform=actor_transform,
                compute=compute, num_cpus=num_cpus,
                udf_constructor=udf_constructor)
            return Dataset(self._plan.with_stage(stage), self._epoch)

        def transform(block, _fn=fn, _fmt=batch_format, _bs=batch_size):
            return _map_batches_block(block, _fn, _fmt, _bs)

        stage = OneToOneStage(name="map_batches", transform=transform,
                              compute=compute, num_cpus=num_cpus)
        return Dataset(self._plan.with_stage(stage), self._epoch)

    def map(self, fn: RowUDF, *, compute=None, num_cpus: float = 1.0
            ) -> "Dataset":
        def transform(block, _fn=fn):
            acc = BlockAccessor.for_block(block)
            rows = [_fn(row) for row in acc.iter_rows()]
            return _rows_to_block(rows)

        stage = OneToOneStage(name="map", transform=transform,
                              compute=resolve_compute(compute),
                              num_cpus=num_cpus)
        return Dataset(self._plan.with_stage(stage), self._epoch)

    def flat_map(self, fn: RowUDF, *, compute=None, num_cpus: float = 1.0
                 ) -> "Dataset":
        def transform(block, _fn=fn):
            acc = BlockAccessor.for_block(block)
            rows = [out for row in acc.iter_rows() for out in _fn(row)]
            return _rows_to_block(rows)

        stage = OneToOneStage(name="flat_map", transform=transform,
                              compute=resolve_compute(compute),
                              num_cpus=num_cpus)
        return Dataset(self._plan.with_stage(stage), self._epoch)

    def filter(self, fn: RowUDF, *, compute=None, num_cpus: float = 1.0
               ) -> "Dataset":
        def transform(block, _fn=fn):
            acc = BlockAccessor.for_block(block)
            keep = [i for i, row in enumerate(acc.iter_rows()) if _fn(row)]
            return acc.take(keep)

        stage = OneToOneStage(name="filter", transform=transform,
                              compute=resolve_compute(compute),
                              num_cpus=num_cpus)
        return Dataset(self._plan.with_stage(stage), self._epoch)

    def select_columns(self, cols: List[str], **kwargs) -> "Dataset":
        def transform(block, _cols=tuple(cols)):
            return BlockAccessor.for_block(block).select_columns(list(_cols))

        stage = OneToOneStage(name="select_columns", transform=transform)
        return Dataset(self._plan.with_stage(stage), self._epoch)

    def drop_columns(self, cols: List[str], **kwargs) -> "Dataset":
        def transform(block, _drop=tuple(cols)):
            acc = BlockAccessor.for_block(block)
            tbl = acc.to_arrow()
            keep = [c for c in tbl.column_names if c not in _drop]
            return tbl.select(keep)

        stage = OneToOneStage(name="drop_columns", transform=transform)
        return Dataset(self._plan.with_stage(stage), self._epoch)

    def add_column(self, name: str, fn: Callable[[Any], Any], **kwargs
                   ) -> "Dataset":
        def transform(block, _name=name, _fn=fn):
            acc = BlockAccessor.for_block(block)
            df = acc.to_pandas().copy()
            df[_name] = _fn(df)
            return df

        stage = OneToOneStage(name="add_column", transform=transform)
        return Dataset(self._plan.with_stage(stage), self._epoch)

    # ------------------------------------------------------------------
    # All-to-all transforms
    # ------------------------------------------------------------------

    def repartition(self, num_blocks: int, *, shuffle: bool = False
                    ) -> "Dataset":
        def fn(blocks, metas, _n=num_blocks, _shuffle=shuffle):
            if _shuffle:
                return shuffle_blocks(blocks, _n, mode="random")
            # Order-preserving: slice the global row sequence evenly.
            total = sum(m.num_rows or 0 for m in metas)
            offsets = [(i * total) // _n for i in range(_n)] + [total]
            out = self._slice_rows(blocks, offsets)
            out_metas = [BlockAccessor.for_block(b).get_metadata()
                         for b in ray_tpu_torch.get(out)]
            return out, out_metas

        return Dataset(self._plan.with_stage(
            AllToAllStage("repartition", fn)), self._epoch)

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        def fn(blocks, metas, _seed=seed, _n=num_blocks):
            blocks, metas = shuffle_blocks(blocks, _n or len(blocks),
                                           mode="random", seed=_seed)
            # Shuffle rows within each output block too. Each block gets
            # its OWN stream (seed + index): a shared seed would apply the
            # same permutation to equal-sized blocks, leaving the "random"
            # shuffle structurally correlated across blocks.
            def _permute(block, s):
                acc = BlockAccessor.for_block(block)
                n = acc.num_rows()
                rng = np.random.default_rng(s)
                return acc.take(rng.permutation(n).tolist())
            out_blocks = []
            task = ray_tpu_torch.remote(_permute)
            for i, b in enumerate(blocks):
                out_blocks.append(task.remote(
                    b, None if _seed is None else _seed + i))
            return out_blocks, metas

        return Dataset(self._plan.with_stage(
            AllToAllStage("random_shuffle", fn)), self._epoch)

    def randomize_block_order(self, *, seed: Optional[int] = None
                              ) -> "Dataset":
        def fn(blocks, metas, _seed=seed):
            rng = np.random.default_rng(_seed)
            order = rng.permutation(len(blocks)).tolist()
            return [blocks[i] for i in order], [metas[i] for i in order]

        return Dataset(self._plan.with_stage(
            AllToAllStage("randomize_block_order", fn)), self._epoch)

    def sort(self, key: Optional[str] = None, descending: bool = False
             ) -> "Dataset":
        def fn(blocks, metas, _key=key, _desc=descending):
            return sort_blocks(blocks, key=_key, descending=_desc)

        return Dataset(self._plan.with_stage(AllToAllStage("sort", fn)),
                       self._epoch)

    def groupby(self, key: Optional[str]) -> "GroupedDataset":
        return GroupedDataset(self, key)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of equal-length datasets."""
        left = self.materialize()
        right = other.repartition_like(left)

        def _zip(a, b):
            import pyarrow as pa
            ta = BlockAccessor.for_block(a).to_arrow()
            tb = BlockAccessor.for_block(b).to_arrow()
            cols = list(ta.columns) + list(tb.columns)
            names = list(ta.column_names)
            for n in tb.column_names:
                names.append(n if n not in ta.column_names else n + "_1")
            return pa.table(cols, names=names)

        task = ray_tpu_torch.remote(_zip)
        lb, lm = left._execute()
        rb, _ = right._execute()
        if len(lb) != len(rb):
            raise ValueError("zip requires equal block counts")
        out = [task.remote(a, b) for a, b in zip(lb, rb)]
        metas = [BlockAccessor.for_block(b).get_metadata()
                 for b in ray_tpu_torch.get(out)]
        return Dataset.from_blocks(out, metas)

    def repartition_like(self, other: "Dataset") -> "Dataset":
        """Repartition so block row counts match ``other`` (zip helper)."""
        counts = [m.num_rows for m in other._execute()[1]]
        blocks, _ = self._execute()
        offsets = np.cumsum([0] + counts)
        rows_blocks = self._slice_rows(blocks, offsets)
        metas = [BlockAccessor.for_block(ray_tpu_torch.get(b)).get_metadata()
                 for b in rows_blocks]
        return Dataset.from_blocks(rows_blocks, metas)

    def _slice_rows(self, blocks, offsets):
        """Re-slice blocks to the [offsets] row boundaries."""
        def _slice(start, end, *blks):
            merged = BlockAccessor.concat(list(blks))
            return BlockAccessor.for_block(merged).slice(start, end)

        task = ray_tpu_torch.remote(_slice)
        out = []
        for i in range(len(offsets) - 1):
            out.append(task.remote(int(offsets[i]), int(offsets[i + 1]),
                                   *blocks))
        return out

    def union(self, *others: "Dataset") -> "Dataset":
        blocks, metas = [list(x) for x in self._execute()]
        for o in others:
            ob, om = o._execute()
            blocks.extend(ob)
            metas.extend(om)
        return Dataset.from_blocks(blocks, metas)

    # ------------------------------------------------------------------
    # Splitting / consumption
    # ------------------------------------------------------------------

    def split(self, n: int, *, equal: bool = False, locality_hints=None
              ) -> List["Dataset"]:
        """Split into n datasets by block (equal=True balances rows) —
        the Train ingest path (reference: dataset.py split / train
        _internal/dataset_spec.py)."""
        blocks, metas = self._execute()
        if equal:
            total = sum(m.num_rows or 0 for m in metas)
            per = total // n
            offsets = [i * per for i in range(n)] + [per * n]
            parts = self._slice_rows(blocks, offsets)
            out = []
            for ref in parts:
                block = ray_tpu_torch.get(ref)
                out.append(Dataset.from_blocks(
                    [ref], [BlockAccessor.for_block(block).get_metadata()]))
            return out
        out = []
        for i in range(n):
            sel = list(range(i, len(blocks), n))
            out.append(Dataset.from_blocks([blocks[j] for j in sel],
                                           [metas[j] for j in sel]))
        return out

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None) -> List["DataIterator"]:
        """n disjoint iterators over this dataset — the per-worker Train
        ingest handles (reference: dataset.streaming_split feeding one
        DataIterator per train worker). Blocks are assigned round-robin;
        execution streams through the operator pipeline on first use."""
        if n <= 0:
            raise ValueError(f"streaming_split requires n >= 1, got {n}")
        return [DataIterator(self, shard_index=i, num_shards=n,
                             equal=equal, locality_hints=locality_hints)
                for i in range(n)]

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        blocks, metas = self._execute()
        total = sum(m.num_rows or 0 for m in metas)
        offsets = [0] + list(indices) + [total]
        parts = self._slice_rows(blocks, offsets)
        out = []
        for ref in parts:
            block = ray_tpu_torch.get(ref)
            out.append(Dataset.from_blocks(
                [ref], [BlockAccessor.for_block(block).get_metadata()]))
        return out

    def limit(self, n: int) -> "Dataset":
        blocks, metas = self._execute()
        out_blocks, out_metas, used = [], [], 0
        for b, m in zip(blocks, metas):
            if used >= n:
                break
            rows = m.num_rows or 0
            if used + rows <= n:
                out_blocks.append(b)
                out_metas.append(m)
                used += rows
            else:
                take = n - used

                def _head(block, _take=take):
                    return BlockAccessor.for_block(block).slice(0, _take)

                ref = ray_tpu_torch.remote(_head).remote(b)
                out_blocks.append(ref)
                out_metas.append(BlockAccessor.for_block(
                    ray_tpu_torch.get(ref)).get_metadata())
                used = n
        return Dataset.from_blocks(out_blocks, out_metas)

    def take(self, n: int = 20) -> List[Any]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def count(self) -> int:
        _, metas = self._execute()
        return sum(m.num_rows or 0 for m in metas)

    def num_blocks(self) -> int:
        return len(self._execute()[0])

    def size_bytes(self) -> int:
        _, metas = self._execute()
        return sum(m.size_bytes or 0 for m in metas)

    def schema(self):
        _, metas = self._execute()
        for m in metas:
            if m.schema is not None:
                return m.schema
        return None

    def columns(self) -> Optional[List[str]]:
        s = self.schema()
        if s is None:
            return None
        try:
            return list(s.names)
        except AttributeError:
            return None

    def input_files(self) -> List[str]:
        _, metas = self._execute()
        return sorted({f for m in metas for f in m.input_files})

    def stats(self) -> str:
        return (f"Dataset(num_blocks={self.num_blocks()}, "
                f"num_rows={self.count()}, "
                f"stages={self._plan.stage_names()})")

    def __repr__(self) -> str:
        try:
            n = self.count()
        except Exception:
            n = "?"
        return f"Dataset(num_blocks={self.num_blocks()}, num_rows={n})"

    # ------------------------------------------------------------------
    # Iteration
    # ------------------------------------------------------------------

    def iter_rows(self) -> Iterator[Any]:
        for block in self._iter_blocks():
            acc = BlockAccessor.for_block(block)
            is_simple = isinstance(block, list)
            for row in acc.iter_rows():
                yield row

    def _iter_blocks(self) -> Iterator[Block]:
        if not self._plan.is_executed():
            # Streaming execution: blocks flow through the whole operator
            # chain as they're produced (reference: streaming_executor.py) —
            # first batch latency is one block's traversal, not a full
            # materialization.
            for block_ref, _meta in self._plan.iter_execute():
                yield ray_tpu_torch.get(block_ref)
            return
        blocks, _ = self._execute()
        # Prefetch one block ahead while the consumer processes the current
        # one (reference: block prefetching in iter_batches).
        for i, ref in enumerate(blocks):
            if i + 1 < len(blocks):
                ray_tpu_torch.wait([blocks[i + 1]], num_returns=1, timeout=0)
            yield ray_tpu_torch.get(ref)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: Optional[str] = "numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     prefetch_batches: int = 1) -> Iterator[Any]:
        """Iterate formatted batches. The TPU ingest hot path."""
        carry: Optional[Block] = None
        rng = (np.random.default_rng(local_shuffle_seed)
               if local_shuffle_buffer_size else None)
        for block in self._iter_blocks():
            if carry is not None:
                block = BlockAccessor.concat([carry, block])
                carry = None
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            if batch_size is None:
                yield acc.to_batch_format(batch_format)
                continue
            start = 0
            while n - start >= batch_size:
                piece = acc.slice(start, start + batch_size)
                if rng is not None:
                    pacc = BlockAccessor.for_block(piece)
                    piece = pacc.take(
                        rng.permutation(batch_size).tolist())
                yield BlockAccessor.for_block(piece).to_batch_format(
                    batch_format)
                start += batch_size
            if start < n:
                carry = acc.slice(start, n)
        if carry is not None and not drop_last:
            yield BlockAccessor.for_block(carry).to_batch_format(batch_format)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           dtypes: Optional[dict] = None,
                           device=None, drop_last: bool = True,
                           **kwargs) -> Iterator[Dict[str, Any]]:
        """Batches as torch tensors on ``device`` (the card unless "cpu" is
        asked for; raises without one), the reference's
        iter_torch_batches (dataset.py). Each column keeps the dtype the
        JAX package's batches have: a 64-bit one becomes its 32-bit
        type, as jax.device_put makes it."""
        import torch

        from ray_tpu_torch._private.device import jax_dtype, resolve_device
        dev = resolve_device(device)
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last, **kwargs):
            out = {}
            for k, v in batch.items():
                if dtypes and k in dtypes:
                    v = v.astype(dtypes[k])
                v = np.asarray(v)
                out[k] = torch.tensor(v.astype(jax_dtype(v.dtype),
                                               copy=False), device=dev)
            yield out

    def to_pandas(self, limit: int = 100_000):
        import pandas as pd
        blocks, metas = self._execute()
        total = sum(m.num_rows or 0 for m in metas)
        if total > limit:
            raise ValueError(
                f"Dataset has {total} rows > limit {limit}; pass a larger "
                "limit to to_pandas")
        frames = [BlockAccessor.for_block(b).to_pandas()
                  for b in ray_tpu_torch.get(list(blocks))]
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def to_arrow_refs(self) -> List[Any]:
        return list(self._execute()[0])

    def to_numpy_refs(self) -> List[Any]:
        def _conv(block):
            return BlockAccessor.for_block(block).to_numpy()

        task = ray_tpu_torch.remote(_conv)
        return [task.remote(b) for b in self._execute()[0]]

    # ------------------------------------------------------------------
    # Global aggregates
    # ------------------------------------------------------------------

    def aggregate(self, *aggs: agg_mod.AggregateFn) -> Any:
        def _acc_block(block, _aggs=aggs):
            acc = BlockAccessor.for_block(block)
            batch = acc.to_numpy()
            return [a.accumulate_block(a.init(None), batch) for a in _aggs]

        task = ray_tpu_torch.remote(_acc_block)
        partials = ray_tpu_torch.get([task.remote(b)
                                for b in self._execute()[0]])
        results = []
        for i, a in enumerate(aggs):
            state = a.init(None)
            for p in partials:
                state = a.merge(state, p[i])
            results.append(a.finalize(state))
        if len(results) == 1:
            return results[0]
        return tuple(results)

    def sum(self, on: Optional[str] = None):
        return self.aggregate(agg_mod.Sum(on))

    def min(self, on: Optional[str] = None):
        return self.aggregate(agg_mod.Min(on))

    def max(self, on: Optional[str] = None):
        return self.aggregate(agg_mod.Max(on))

    def mean(self, on: Optional[str] = None):
        return self.aggregate(agg_mod.Mean(on))

    def std(self, on: Optional[str] = None, ddof: int = 1):
        return self.aggregate(agg_mod.Std(on, ddof))

    def unique(self, column: str) -> List[Any]:
        def _uniq(block, _c=column):
            return list(set(
                BlockAccessor.for_block(block).column_values(_c).tolist()))

        task = ray_tpu_torch.remote(_uniq)
        out = set()
        for part in ray_tpu_torch.get([task.remote(b)
                                 for b in self._execute()[0]]):
            out.update(part)
        return sorted(out)

    # ------------------------------------------------------------------
    # Writes
    # ------------------------------------------------------------------

    def write_parquet(self, path: str, **kwargs) -> None:
        self._write_files(path, "parquet", **kwargs)

    def write_csv(self, path: str, **kwargs) -> None:
        self._write_files(path, "csv", **kwargs)

    def write_json(self, path: str, **kwargs) -> None:
        self._write_files(path, "json", **kwargs)

    def write_tfrecords(self, path: str, **kwargs) -> None:
        """One .tfrecord file of tf.train.Example records per block
        (reference: Dataset.write_tfrecords) — no TF dependency
        (data/tfrecord.py); block writes run as parallel tasks like the
        other write formats."""
        import os
        os.makedirs(path, exist_ok=True)

        def _write(block, idx, _path=path):
            import os

            from ray_tpu_torch.data.tfrecord import (encode_example,
                                               write_tfrecord_file)
            acc = BlockAccessor.for_block(block)
            records = [encode_example(row) for row in acc.iter_rows()]
            fname = os.path.join(_path, f"part-{idx:05d}.tfrecord")
            write_tfrecord_file(fname, records)
            return fname

        task = ray_tpu_torch.remote(_write)
        blocks, _ = self._execute()
        ray_tpu_torch.get([task.remote(b, i) for i, b in enumerate(blocks)])

    def write_numpy(self, path: str, column: str = "data", **kwargs) -> None:
        self._write_files(path, "numpy", column=column, **kwargs)

    def _write_files(self, path: str, fmt: str, column: str = "data",
                     **kwargs) -> None:
        import os
        os.makedirs(path, exist_ok=True)

        def _write(block, idx, _path=path, _fmt=fmt, _col=column):
            import os
            acc = BlockAccessor.for_block(block)
            ext = {"parquet": "parquet", "csv": "csv", "json": "json",
                   "numpy": "npy"}[_fmt]
            fname = os.path.join(_path, f"{idx:06d}.{ext}")
            if _fmt == "parquet":
                import pyarrow.parquet as pq
                pq.write_table(acc.to_arrow(), fname)
            elif _fmt == "csv":
                acc.to_pandas().to_csv(fname, index=False)
            elif _fmt == "json":
                acc.to_pandas().to_json(fname, orient="records", lines=True)
            else:
                np.save(fname, acc.to_numpy().get(_col))
            return fname

        task = ray_tpu_torch.remote(_write)
        blocks, _ = self._execute()
        ray_tpu_torch.get([task.remote(b, i) for i, b in enumerate(blocks)])

    # ------------------------------------------------------------------
    # Pipeline / epochs
    # ------------------------------------------------------------------

    def window(self, *, blocks_per_window: int = 10):
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
        return DatasetPipeline.from_dataset(self, blocks_per_window)

    def repeat(self, times: Optional[int] = None):
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
        return DatasetPipeline.from_dataset_repeated(self, times)


class GroupedDataset:
    """Hash-partition by key, then per-partition grouped aggregation
    (reference: data/grouped_dataset.py)."""

    def __init__(self, ds: Dataset, key: Optional[str]):
        self._ds = ds
        self._key = key

    def aggregate(self, *aggs: agg_mod.AggregateFn) -> Dataset:
        key = self._key
        blocks, _ = self._ds._execute()
        shuffled, _ = shuffle_blocks(blocks, len(blocks), mode="hash",
                                     key=key)

        def _group_agg(block, _key=key, _aggs=aggs):
            import pandas as pd
            acc = BlockAccessor.for_block(block)
            df = acc.to_pandas()
            if len(df) == 0:
                return df.head(0)
            rows = []
            for gval, gdf in df.groupby(_key, sort=True):
                batch = {c: gdf[c].to_numpy() for c in gdf.columns}
                row = {_key: gval}
                for a in _aggs:
                    state = a.accumulate_block(a.init(gval), batch)
                    row[a.name] = a.finalize(state)
                rows.append(row)
            return pd.DataFrame(rows)

        task = ray_tpu_torch.remote(_group_agg)
        out = [task.remote(b) for b in shuffled]
        metas = [BlockAccessor.for_block(b).get_metadata()
                 for b in ray_tpu_torch.get(out)]
        return Dataset.from_blocks(out, metas)

    def count(self) -> Dataset:
        return self.aggregate(agg_mod.Count())

    def sum(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(agg_mod.Sum(on))

    def min(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(agg_mod.Min(on))

    def max(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(agg_mod.Max(on))

    def mean(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(agg_mod.Mean(on))

    def std(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(agg_mod.Std(on))

    def map_groups(self, fn: Callable) -> Dataset:
        key = self._key
        blocks, _ = self._ds._execute()
        shuffled, _ = shuffle_blocks(blocks, len(blocks), mode="hash",
                                     key=key)

        def _map_groups(block, _key=key, _fn=fn):
            import pandas as pd
            df = BlockAccessor.for_block(block).to_pandas()
            if len(df) == 0:
                return df
            outs = []
            for _, gdf in df.groupby(_key, sort=True):
                out = _fn(gdf)
                outs.append(out if isinstance(out, pd.DataFrame)
                            else pd.DataFrame(out))
            return pd.concat(outs, ignore_index=True)

        task = ray_tpu_torch.remote(_map_groups)
        out = [task.remote(b) for b in shuffled]
        metas = [BlockAccessor.for_block(b).get_metadata()
                 for b in ray_tpu_torch.get(out)]
        return Dataset.from_blocks(out, metas)


def _map_batches_block(block: Block, fn, batch_format, batch_size) -> Block:
    acc = BlockAccessor.for_block(block)
    n = acc.num_rows()
    if n == 0:
        return block
    outs = []
    step = batch_size or n
    for start in range(0, n, step):
        piece = acc.slice(start, min(start + step, n))
        batch = BlockAccessor.for_block(piece).to_batch_format(batch_format)
        out = fn(batch)
        outs.append(BlockAccessor.batch_to_block(out))
    return BlockAccessor.concat(outs)


def _rows_to_block(rows: List[Any]) -> Block:
    if rows and isinstance(rows[0], dict):
        import pandas as pd
        import pyarrow as pa
        try:
            return pa.Table.from_pylist(rows)
        except Exception:
            return pd.DataFrame(rows)
    return list(rows)


class DataIterator:
    """A shard-scoped iterator over a Dataset (reference: DataIterator
    returned by streaming_split): each of the n iterators sees a disjoint
    round-robin subset of blocks, exposing the same iteration surface the
    full Dataset does (iter_batches / iter_rows / iter_torch_batches)."""

    def __init__(self, dataset: Dataset, shard_index: int, num_shards: int,
                 equal: bool = False, locality_hints=None):
        self._dataset = dataset
        self._shard_index = shard_index
        self._num_shards = num_shards
        self._equal = equal
        self._locality_hints = locality_hints
        self._shard: Optional[Dataset] = None

    def _materialize_shard(self) -> Dataset:
        if self._shard is None:
            self._shard = self._dataset.split(
                self._num_shards, equal=self._equal,
                locality_hints=self._locality_hints)[self._shard_index]
        return self._shard

    def iter_batches(self, **kwargs) -> Iterator[Any]:
        return self._materialize_shard().iter_batches(**kwargs)

    def iter_rows(self) -> Iterator[Any]:
        return self._materialize_shard().iter_rows()

    def iter_torch_batches(self, **kwargs) -> Iterator[Dict[str, Any]]:
        return self._materialize_shard().iter_torch_batches(**kwargs)

    def materialize(self) -> Dataset:
        return self._materialize_shard().materialize()

    def count(self) -> int:
        return self._materialize_shard().count()

    def __repr__(self):
        return (f"DataIterator(shard={self._shard_index}/"
                f"{self._num_shards})")

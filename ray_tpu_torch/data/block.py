"""Blocks: the unit of distributed data.

Analog of the reference's python/ray/data/block.py + _internal/arrow_block.py
/ pandas_block.py / simple_block.py: a Dataset is a list of object-store
refs to *blocks*; a BlockAccessor provides a uniform view over the three
block representations (pyarrow.Table — canonical, pandas.DataFrame, and a
plain Python list for non-tabular rows).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

# A Block is one of: pyarrow.Table, pandas.DataFrame, list (simple rows).
Block = Any

# Column name used when wrapping non-dict values into tabular form.
VALUE_COL = "value"
# Column name used for tensor datasets (range_tensor, from_numpy).
TENSOR_COL = "data"


@dataclass
class BlockMetadata:
    """Per-block stats carried alongside the block ref (reference:
    data/block.py BlockMetadata)."""

    num_rows: Optional[int] = None
    size_bytes: Optional[int] = None
    schema: Any = None
    input_files: List[str] = field(default_factory=list)


def _is_arrow(block) -> bool:
    import pyarrow as pa
    return isinstance(block, pa.Table)


def _is_pandas(block) -> bool:
    import pandas as pd
    return isinstance(block, pd.DataFrame)


class BlockAccessor:
    """Uniform operations over a block. Use ``BlockAccessor.for_block``."""

    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        if _is_arrow(block):
            return ArrowBlockAccessor(block)
        if _is_pandas(block):
            return PandasBlockAccessor(block)
        if isinstance(block, list):
            return SimpleBlockAccessor(block)
        raise TypeError(f"Not a block type: {type(block).__name__}")

    @staticmethod
    def batch_to_block(batch: Any) -> Block:
        """Convert a user-returned batch (dict of arrays / DataFrame /
        pyarrow Table / list) into a block."""
        import pandas as pd
        import pyarrow as pa
        if isinstance(batch, (pa.Table, pd.DataFrame, list)):
            return batch
        if isinstance(batch, dict):
            cols = {}
            for k, v in batch.items():
                v = np.asarray(v) if not isinstance(v, np.ndarray) else v
                cols[k] = v
            return _numpy_dict_to_arrow(cols)
        if isinstance(batch, np.ndarray):
            return _numpy_dict_to_arrow({TENSOR_COL: batch})
        raise TypeError(
            "map_batches UDF must return dict[str, np.ndarray], DataFrame, "
            f"pyarrow.Table, np.ndarray, or list; got {type(batch).__name__}")

    # -- interface -------------------------------------------------------
    def num_rows(self) -> int:
        raise NotImplementedError

    def size_bytes(self) -> int:
        raise NotImplementedError

    def schema(self) -> Any:
        raise NotImplementedError

    def slice(self, start: int, end: int) -> Block:
        raise NotImplementedError

    def take(self, indices: List[int]) -> Block:
        raise NotImplementedError

    def iter_rows(self) -> Iterator[Any]:
        raise NotImplementedError

    def to_pandas(self):
        raise NotImplementedError

    def to_arrow(self):
        raise NotImplementedError

    def to_numpy(self, columns=None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def to_batch_format(self, batch_format: Optional[str]) -> Any:
        if batch_format in (None, "default", "native", "numpy"):
            out = self.to_numpy()
            if batch_format == "numpy" or isinstance(self, SimpleBlockAccessor):
                return out
            # default for tabular blocks is numpy dict too (TPU-first: the
            # training path wants host numpy it can device_put).
            return out
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow()
        raise ValueError(f"Unknown batch_format: {batch_format!r}")

    def select_columns(self, cols: List[str]) -> Block:
        raise NotImplementedError

    def column_values(self, col: Optional[str]) -> np.ndarray:
        """Values of one column (or the single value column)."""
        raise NotImplementedError

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        """Concatenate same-kind blocks."""
        blocks = [b for b in blocks if BlockAccessor.for_block(b).num_rows()]
        if not blocks:
            return []
        first = blocks[0]
        if isinstance(first, list):
            out: List[Any] = []
            for b in blocks:
                out.extend(b)
            return out
        import pandas as pd
        import pyarrow as pa
        if _is_pandas(first):
            return pd.concat([BlockAccessor.for_block(b).to_pandas()
                              for b in blocks], ignore_index=True)
        return pa.concat_tables(
            [BlockAccessor.for_block(b).to_arrow() for b in blocks],
            promote_options="default")

    def get_metadata(self, input_files: Optional[List[str]] = None
                     ) -> BlockMetadata:
        return BlockMetadata(
            num_rows=self.num_rows(),
            size_bytes=self.size_bytes(),
            schema=self.schema(),
            input_files=list(input_files or []),
        )

    def sample_keys(self, n: int, key: Optional[str]) -> List[Any]:
        total = self.num_rows()
        if total == 0:
            return []
        idx = np.linspace(0, total - 1, min(n, total)).astype(int)
        vals = self.column_values(key)
        return [vals[i] for i in idx]

    def sort_by(self, key: Optional[str], descending: bool = False) -> Block:
        raise NotImplementedError


def _numpy_dict_to_arrow(cols: Dict[str, np.ndarray]):
    import pyarrow as pa
    arrays = []
    names = []
    for k, v in cols.items():
        v = np.asarray(v)
        if v.ndim <= 1:
            arrays.append(pa.array(v))
        elif v[0].size == 0:
            # Zero-size element shape: FixedSizeList(size=0) is invalid
            # in arrow — keep the legacy list-of-lists representation.
            arrays.append(pa.array(v.tolist()))
        else:
            # N-d tensors: fixed-shape extension column, zero-copy from
            # the contiguous values (reference:
            # data/extensions/tensor_extension.py ArrowTensorArray).
            # Like the reference's fixed-shape tensor type, every batch
            # of a column must share one element shape (the shape is
            # part of the arrow type).
            from ray_tpu_torch.data.extensions import ArrowTensorArray
            arrays.append(ArrowTensorArray.from_numpy(v))
        names.append(k)
    return pa.table(arrays, names=names)


class ArrowBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return self._block.num_rows

    def size_bytes(self) -> int:
        return self._block.nbytes

    def schema(self):
        return self._block.schema

    def slice(self, start: int, end: int) -> Block:
        return self._block.slice(start, end - start)

    def take(self, indices: List[int]) -> Block:
        if len(indices) == 0:
            return self._block.slice(0, 0)
        return self._block.take(np.asarray(indices, dtype=np.int64))

    def iter_rows(self):
        for batch in self._block.to_batches():
            yield from batch.to_pylist()

    def to_pandas(self):
        return self._block.to_pandas()

    def to_arrow(self):
        return self._block

    def to_numpy(self, columns=None) -> Dict[str, np.ndarray]:
        from ray_tpu_torch.data.extensions import ArrowTensorType
        cols = columns or self._block.column_names
        out = {}
        for c in cols:
            col = self._block[c]
            if isinstance(col.type, ArrowTensorType):
                out[c] = col.combine_chunks().to_numpy(
                    zero_copy_only=False)
                continue
            try:
                out[c] = col.to_numpy(zero_copy_only=False)
            except Exception:
                out[c] = np.array(col.to_pylist(), dtype=object)
        # Stack nested list columns into ndarrays when rectangular.
        for k, v in out.items():
            if v.dtype == object and len(v) and isinstance(v[0], (list, np.ndarray)):
                try:
                    stacked = np.array(self._block[k].to_pylist())
                    if stacked.dtype != object:
                        out[k] = stacked
                except ValueError:
                    pass
        return out

    def select_columns(self, cols: List[str]) -> Block:
        return self._block.select(cols)

    def column_values(self, col: Optional[str]) -> np.ndarray:
        if col is None:
            col = self._block.column_names[0]
        return self._block[col].to_numpy(zero_copy_only=False)

    def sort_by(self, key, descending=False) -> Block:
        if key is None:
            key = self._block.column_names[0]
        order = "descending" if descending else "ascending"
        return self._block.sort_by([(key, order)])


class PandasBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return len(self._block)

    def size_bytes(self) -> int:
        return int(self._block.memory_usage(deep=True).sum())

    def schema(self):
        return self._block.dtypes

    def slice(self, start: int, end: int) -> Block:
        return self._block.iloc[start:end]

    def take(self, indices: List[int]) -> Block:
        return self._block.iloc[indices]

    def iter_rows(self):
        for row in self._block.to_dict(orient="records"):
            yield row

    def to_pandas(self):
        return self._block

    def to_arrow(self):
        import pyarrow as pa
        return pa.Table.from_pandas(self._block, preserve_index=False)

    def to_numpy(self, columns=None) -> Dict[str, np.ndarray]:
        cols = columns or list(self._block.columns)
        return {c: self._block[c].to_numpy() for c in cols}

    def select_columns(self, cols: List[str]) -> Block:
        return self._block[cols]

    def column_values(self, col: Optional[str]) -> np.ndarray:
        if col is None:
            col = self._block.columns[0]
        return self._block[col].to_numpy()

    def sort_by(self, key, descending=False) -> Block:
        if key is None:
            key = self._block.columns[0]
        return self._block.sort_values(key, ascending=not descending)


class SimpleBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return len(self._block)

    def size_bytes(self) -> int:
        import sys
        return sum(sys.getsizeof(x) for x in self._block[:10]) * max(
            1, len(self._block) // max(len(self._block[:10]), 1))

    def schema(self):
        return type(self._block[0]).__name__ if self._block else None

    def slice(self, start: int, end: int) -> Block:
        return self._block[start:end]

    def take(self, indices: List[int]) -> Block:
        return [self._block[i] for i in indices]

    def iter_rows(self):
        return iter(self._block)

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame({VALUE_COL: self._block})

    def to_arrow(self):
        import pyarrow as pa
        return pa.table({VALUE_COL: self._block})

    def to_numpy(self, columns=None) -> Dict[str, np.ndarray]:
        return {VALUE_COL: np.array(self._block)}

    def select_columns(self, cols: List[str]) -> Block:
        raise ValueError("Simple blocks have no columns")

    def column_values(self, col: Optional[str]) -> np.ndarray:
        return np.array(self._block, dtype=object)

    def sort_by(self, key, descending=False) -> Block:
        return sorted(self._block, key=key if callable(key) else None,
                      reverse=descending)

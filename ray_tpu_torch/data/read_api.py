"""Dataset creation: range/from_items/from_pandas/... and file readers.

Analog of the reference's python/ray/data/read_api.py (read_datasource at
read_api.py:237): every reader plans a set of read tasks, one per output
block, executed lazily as object-store tasks.
"""

from __future__ import annotations

import builtins
import os
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (TENSOR_COL, VALUE_COL, Block, BlockAccessor,
                                BlockMetadata)
from ray_tpu_torch.data.dataset import Dataset

DEFAULT_PARALLELISM = 8


def _put_blocks(blocks: List[Block], input_files=None) -> Dataset:
    refs, metas = [], []
    for b in blocks:
        refs.append(ray_tpu_torch.put(b))
        metas.append(BlockAccessor.for_block(b).get_metadata(input_files))
    return Dataset.from_blocks(refs, metas)


def _split_list(items: List[Any], n: int) -> List[List[Any]]:
    n = max(1, min(n, len(items))) if items else 1
    per = (len(items) + n - 1) // n if items else 0
    return [items[i * per:(i + 1) * per] for i in builtins.range(n)
            if items[i * per:(i + 1) * per]] or [[]]


def range(n: int, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    """Dataset of dict rows {"id": 0..n-1} (reference: read_api.py range)."""
    import pyarrow as pa
    parallelism = max(1, min(parallelism, n or 1))
    per = (n + parallelism - 1) // parallelism
    blocks = []
    for i in builtins.range(parallelism):
        lo, hi = i * per, min((i + 1) * per, n)
        if lo >= hi and i > 0:
            continue
        blocks.append(pa.table({"id": np.arange(lo, hi, dtype=np.int64)}))
    return _put_blocks(blocks)


def range_tensor(n: int, *, shape: tuple = (1,),
                 parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    parallelism = max(1, min(parallelism, n or 1))
    per = (n + parallelism - 1) // parallelism
    blocks = []
    for i in builtins.range(parallelism):
        lo, hi = i * per, min((i + 1) * per, n)
        if lo >= hi and i > 0:
            continue
        base = np.arange(lo, hi, dtype=np.int64).reshape((-1,) + (1,) * len(shape))
        data = np.broadcast_to(base, (hi - lo,) + tuple(shape)).copy()
        from ray_tpu_torch.data.block import _numpy_dict_to_arrow
        blocks.append(_numpy_dict_to_arrow({TENSOR_COL: data}))
    return _put_blocks(blocks)


def from_items(items: List[Any], *, parallelism: int = DEFAULT_PARALLELISM
               ) -> Dataset:
    import pyarrow as pa
    chunks = _split_list(list(items), parallelism)
    blocks = []
    for chunk in chunks:
        if chunk and isinstance(chunk[0], dict):
            blocks.append(pa.Table.from_pylist(chunk))
        else:
            blocks.append(list(chunk))
    return _put_blocks(blocks)


def from_pandas(dfs) -> Dataset:
    import pandas as pd
    if isinstance(dfs, pd.DataFrame):
        dfs = [dfs]
    return _put_blocks(list(dfs))


def from_arrow(tables) -> Dataset:
    import pyarrow as pa
    if isinstance(tables, pa.Table):
        tables = [tables]
    return _put_blocks(list(tables))


def from_numpy(arrays, column: str = TENSOR_COL) -> Dataset:
    from ray_tpu_torch.data.block import _numpy_dict_to_arrow
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    return _put_blocks([_numpy_dict_to_arrow({column: a}) for a in arrays])


def from_torch(arrays, column: str = TENSOR_COL) -> Dataset:
    """Tensors (on the card too) → host Dataset; bfloat16 as float32."""
    from ray_tpu_torch._private.device import to_host
    if not isinstance(arrays, (list, tuple)):
        arrays = [arrays]
    return from_numpy([to_host(a) for a in arrays], column)


# ----------------------------------------------------------------------
# File-based readers
# ----------------------------------------------------------------------

def _expand_paths(paths: Union[str, List[str]], suffix: Optional[str] = None
                  ) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                full = os.path.join(p, name)
                if os.path.isfile(full) and (
                        suffix is None or name.endswith(suffix)):
                    out.append(full)
        else:
            out.append(p)
    if not out:
        raise ValueError(f"No input files found at {paths}")
    return out


def _read_files(paths: Union[str, List[str]], reader: Callable[[str], Block],
                *, parallelism: int = DEFAULT_PARALLELISM,
                suffix: Optional[str] = None) -> Dataset:
    files = _expand_paths(paths, suffix)

    def _read_group(group: List[str], _reader=reader) -> Block:
        blocks = [_reader(f) for f in group]
        return BlockAccessor.concat(blocks)

    task = ray_tpu_torch.remote(_read_group)
    groups = _split_list(files, parallelism)
    refs = [task.remote(g) for g in groups]
    metas = []
    for ref, group in zip(refs, groups):
        block = ray_tpu_torch.get(ref)
        metas.append(BlockAccessor.for_block(block).get_metadata(group))
    return Dataset.from_blocks(refs, metas)


def read_parquet(paths, *, parallelism: int = DEFAULT_PARALLELISM,
                 columns: Optional[List[str]] = None, **kwargs) -> Dataset:
    def reader(f):
        import pyarrow.parquet as pq
        return pq.read_table(f, columns=columns)

    return _read_files(paths, reader, parallelism=parallelism,
                       suffix=".parquet")


def read_csv(paths, *, parallelism: int = DEFAULT_PARALLELISM, **kwargs
             ) -> Dataset:
    def reader(f):
        import pyarrow.csv as pacsv
        return pacsv.read_csv(f)

    return _read_files(paths, reader, parallelism=parallelism, suffix=".csv")


def read_json(paths, *, parallelism: int = DEFAULT_PARALLELISM, **kwargs
              ) -> Dataset:
    def reader(f):
        import pandas as pd
        return pd.read_json(f, orient="records", lines=True)

    return _read_files(paths, reader, parallelism=parallelism, suffix=".json")


def read_numpy(paths, *, parallelism: int = DEFAULT_PARALLELISM,
               column: str = TENSOR_COL, **kwargs) -> Dataset:
    def reader(f, _col=column):
        from ray_tpu_torch.data.block import _numpy_dict_to_arrow
        return _numpy_dict_to_arrow({_col: np.load(f)})

    return _read_files(paths, reader, parallelism=parallelism, suffix=".npy")


def read_text(paths, *, parallelism: int = DEFAULT_PARALLELISM,
              encoding: str = "utf-8", **kwargs) -> Dataset:
    def reader(f, _enc=encoding):
        import pyarrow as pa
        with open(f, "r", encoding=_enc) as fh:
            lines = [ln.rstrip("\n") for ln in fh]
        return pa.table({"text": lines})

    return _read_files(paths, reader, parallelism=parallelism)


def read_binary_files(paths, *, parallelism: int = DEFAULT_PARALLELISM,
                      include_paths: bool = False, **kwargs) -> Dataset:
    def reader(f, _inc=include_paths):
        import pyarrow as pa
        with open(f, "rb") as fh:
            data = fh.read()
        cols: Dict[str, Any] = {"bytes": [data]}
        if _inc:
            cols["path"] = [f]
        return pa.table(cols)

    return _read_files(paths, reader, parallelism=parallelism)


def read_images(paths, *, parallelism: int = DEFAULT_PARALLELISM,
                size: Optional[tuple] = None, mode: Optional[str] = None,
                include_paths: bool = False, **kwargs) -> Dataset:
    """Decode image files into a tensor column (reference:
    data/datasource/image_datasource.py). ``size=(h, w)`` resizes,
    ``mode`` converts (e.g. "RGB", "L"); images must share one shape
    per file-group (resize or group accordingly)."""
    def reader(f, _size=size, _mode=mode, _inc=include_paths):
        from PIL import Image

        from ray_tpu_torch.data.block import _numpy_dict_to_arrow
        img = Image.open(f)
        if _mode:
            img = img.convert(_mode)
        if _size:
            img = img.resize((_size[1], _size[0]))
        arr = np.asarray(img)
        cols = {"image": arr[None]}
        if _inc:
            cols["path"] = np.asarray([f])
        return _numpy_dict_to_arrow(cols)

    return _read_files(
        paths, reader, parallelism=parallelism,
        suffix=(".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp"))


def read_tfrecords(paths, *, parallelism: int = DEFAULT_PARALLELISM,
                   **kwargs) -> Dataset:
    """Read TFRecord files of tf.train.Example protos WITHOUT a
    TensorFlow dependency (reference: tfrecords_datasource.py imports
    tf; ray_tpu/data/tfrecord.py speaks the wire formats directly).
    Scalar features unwrap to scalars; multi-value features stay
    lists."""
    def reader(f):
        import pyarrow as pa

        from ray_tpu_torch.data.tfrecord import (decode_example,
                                           read_tfrecord_file)
        rows = [decode_example(rec) for rec in read_tfrecord_file(f)]
        cols: Dict[str, Any] = {}
        names: List[str] = []
        for row in rows:
            for name in row:
                if name not in cols:
                    cols[name] = []
                    names.append(name)
        for row in rows:
            for name in names:
                vals = row.get(name, [])
                cols[name].append(
                    vals[0] if len(vals) == 1 else list(vals))
        return pa.table(cols)

    return _read_files(paths, reader, parallelism=parallelism,
                       suffix=".tfrecord")


def read_datasource(datasource, *, parallelism: int = DEFAULT_PARALLELISM,
                    **read_args) -> Dataset:
    """Custom datasource entry point (reference: read_api.py:237). A
    datasource exposes ``prepare_read(parallelism, **args) -> [callable]``;
    each callable returns a Block."""
    read_tasks = datasource.prepare_read(parallelism, **read_args)
    task = ray_tpu_torch.remote(lambda t: t())
    refs = [task.remote(t) for t in read_tasks]
    metas = [BlockAccessor.for_block(b).get_metadata()
             for b in ray_tpu_torch.get(refs)]
    return Dataset.from_blocks(refs, metas)

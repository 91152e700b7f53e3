"""Preprocessors: fit/transform over Datasets.

Analog of the reference's python/ray/data/preprocessor.py +
data/preprocessors/ (scalers, encoders, BatchMapper, Chain, Concatenator):
``fit`` computes dataset statistics with distributed aggregates;
``transform`` is a map_batches stage. Used standalone or passed to a
Trainer (air/config preprocessor plumbing).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np


class Preprocessor:
    _is_fittable = True

    def __init__(self):
        self._fitted = False

    def fit(self, ds) -> "Preprocessor":
        if self._is_fittable:
            self._fit(ds)
        self._fitted = True
        return self

    def fit_transform(self, ds):
        self.fit(ds)
        return self.transform(ds)

    def transform(self, ds):
        if self._is_fittable and not self._fitted:
            raise RuntimeError(
                f"{type(self).__name__} must be fit before transform")
        return ds.map_batches(self._transform_numpy, batch_format="numpy")

    def transform_batch(self, batch: Dict[str, np.ndarray]):
        if self._is_fittable and not self._fitted:
            raise RuntimeError(
                f"{type(self).__name__} must be fit before transform_batch")
        return self._transform_numpy(batch)

    # -- subclass hooks --------------------------------------------------
    def _fit(self, ds) -> None:
        raise NotImplementedError

    def _transform_numpy(self, batch: Dict[str, np.ndarray]):
        raise NotImplementedError


class BatchMapper(Preprocessor):
    """Stateless UDF preprocessor (reference:
    data/preprocessors/batch_mapper.py)."""

    _is_fittable = False

    def __init__(self, fn: Callable, batch_format: str = "numpy"):
        super().__init__()
        self._fn = fn
        self._batch_format = batch_format

    def transform(self, ds):
        return ds.map_batches(self._fn, batch_format=self._batch_format)

    def _transform_numpy(self, batch):
        return self._fn(batch)


class Chain(Preprocessor):
    def __init__(self, *preprocessors: Preprocessor):
        super().__init__()
        self.preprocessors = list(preprocessors)

    def fit(self, ds):
        for p in self.preprocessors:
            ds = p.fit_transform(ds)
        self._fitted = True
        return self

    def fit_transform(self, ds):
        for p in self.preprocessors:
            ds = p.fit_transform(ds)
        self._fitted = True
        return ds

    def transform(self, ds):
        for p in self.preprocessors:
            ds = p.transform(ds)
        return ds

    def transform_batch(self, batch):
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch


class StandardScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds):
        for c in self.columns:
            mean = ds.mean(c)
            std = ds.std(c, ddof=0) or 0.0
            self.stats_[c] = (mean, std)

    def _transform_numpy(self, batch):
        out = dict(batch)
        for c in self.columns:
            mean, std = self.stats_[c]
            denom = std if std else 1.0
            out[c] = (np.asarray(batch[c], dtype=np.float64) - mean) / denom
        return out


class MinMaxScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds):
        for c in self.columns:
            self.stats_[c] = (ds.min(c), ds.max(c))

    def _transform_numpy(self, batch):
        out = dict(batch)
        for c in self.columns:
            lo, hi = self.stats_[c]
            rng = (hi - lo) or 1.0
            out[c] = (np.asarray(batch[c], dtype=np.float64) - lo) / rng
        return out


class LabelEncoder(Preprocessor):
    def __init__(self, label_column: str):
        super().__init__()
        self.label_column = label_column
        self.classes_: Dict[Any, int] = {}

    def _fit(self, ds):
        values = ds.unique(self.label_column)
        self.classes_ = {v: i for i, v in enumerate(values)}

    def _transform_numpy(self, batch):
        out = dict(batch)
        out[self.label_column] = np.array(
            [self.classes_[v] for v in batch[self.label_column]],
            dtype=np.int64)
        return out


class OneHotEncoder(Preprocessor):
    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = columns
        self.classes_: Dict[str, Dict[Any, int]] = {}

    def _fit(self, ds):
        for c in self.columns:
            values = ds.unique(c)
            self.classes_[c] = {v: i for i, v in enumerate(values)}

    def _transform_numpy(self, batch):
        out = dict(batch)
        for c in self.columns:
            mapping = self.classes_[c]
            idx = np.array([mapping[v] for v in batch[c]])
            onehot = np.zeros((len(idx), len(mapping)), dtype=np.float32)
            onehot[np.arange(len(idx)), idx] = 1.0
            del out[c]
            for v, i in mapping.items():
                out[f"{c}_{v}"] = onehot[:, i]
        return out


class SimpleImputer(Preprocessor):
    def __init__(self, columns: List[str], strategy: str = "mean",
                 fill_value: Any = None):
        super().__init__()
        self.columns = columns
        self.strategy = strategy
        self.fill_value = fill_value
        self.stats_: Dict[str, Any] = {}

    def _fit(self, ds):
        for c in self.columns:
            if self.strategy == "mean":
                self.stats_[c] = ds.mean(c)
            elif self.strategy == "constant":
                self.stats_[c] = self.fill_value
            else:
                raise ValueError(self.strategy)

    def _transform_numpy(self, batch):
        out = dict(batch)
        for c in self.columns:
            v = np.asarray(batch[c], dtype=np.float64)
            v = np.where(np.isnan(v), self.stats_[c], v)
            out[c] = v
        return out


class Concatenator(Preprocessor):
    """Concatenate feature columns into one matrix column — the standard
    last step before tensor ingest (reference:
    data/preprocessors/concatenator.py)."""

    _is_fittable = False

    def __init__(self, output_column_name: str = "concat_out",
                 include: Optional[List[str]] = None,
                 exclude: Optional[List[str]] = None,
                 dtype=np.float32):
        super().__init__()
        self.output_column_name = output_column_name
        self.include = include
        self.exclude = set(exclude or [])
        self.dtype = dtype

    def _transform_numpy(self, batch):
        cols = self.include or [c for c in batch if c not in self.exclude]
        mats = [np.asarray(batch[c], dtype=self.dtype).reshape(
            len(batch[c]), -1) for c in cols]
        out = {k: v for k, v in batch.items() if k not in cols}
        out[self.output_column_name] = np.concatenate(mats, axis=1)
        return out

"""Arrow tensor extension: fixed-shape ndarray columns in arrow blocks.

Analog of the reference's data/extensions/tensor_extension.py
(ArrowTensorType/ArrowTensorArray): an N-d numpy column is stored as a
FixedSizeList storage array over the flattened values — ZERO-COPY both
ways for contiguous numeric data — with the logical element shape kept
in extension-type metadata. Before this, rank>=2 batch columns went
through ``pa.array(v.tolist())`` (a full python materialization that
also loses dtype width) and came back via ``to_pylist``.

The type registers with arrow on import, so tensors survive IPC /
serialization round-trips between workers.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import pyarrow as pa


class ArrowTensorType(pa.ExtensionType):
    """Extension type for [*shape]-shaped tensors of a fixed value type;
    one column cell = one tensor."""

    def __init__(self, shape: Tuple[int, ...], value_type: pa.DataType):
        self._shape = tuple(int(d) for d in shape)
        size = int(np.prod(self._shape)) if self._shape else 1
        storage = pa.list_(value_type, size)
        super().__init__(storage, "ray_tpu_torch.data.tensor")

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    def __arrow_ext_serialize__(self) -> bytes:
        return json.dumps({"shape": list(self._shape)}).encode()

    @classmethod
    def __arrow_ext_deserialize__(cls, storage_type, serialized):
        shape = tuple(json.loads(serialized.decode())["shape"])
        return cls(shape, storage_type.value_type)

    def __arrow_ext_class__(self):
        return ArrowTensorArray

    def __reduce__(self):
        return (ArrowTensorType.__arrow_ext_deserialize__,
                (self.storage_type, self.__arrow_ext_serialize__()))


class ArrowTensorArray(pa.ExtensionArray):
    """Array of fixed-shape tensors over FixedSizeList storage."""

    @staticmethod
    def from_numpy(arr: np.ndarray) -> "ArrowTensorArray":
        """[N, *shape] ndarray -> tensor column; zero-copy for
        contiguous numeric input."""
        arr = np.asarray(arr)
        if arr.ndim < 2:
            raise ValueError(
                f"tensor column needs rank >= 2 ([N, *shape]); got "
                f"rank {arr.ndim}")
        n = arr.shape[0]
        shape = arr.shape[1:]
        flat = np.ascontiguousarray(arr).reshape(n, -1).reshape(-1)
        values = pa.array(flat)
        size = int(np.prod(shape)) if shape else 1
        storage = pa.FixedSizeListArray.from_arrays(values, size)
        typ = ArrowTensorType(shape, values.type)
        return pa.ExtensionArray.from_storage(typ, storage)

    def to_numpy(self, zero_copy_only: bool = True) -> np.ndarray:
        """-> [N, *shape] ndarray; zero-copy when the storage is
        null-free numeric. flatten(), not .values: a SLICED array's
        values still span the whole parent buffer — flatten respects
        the slice offset/length (and is zero-copy for offset slices of
        fixed-size lists)."""
        values = self.storage.flatten()
        np_values = values.to_numpy(zero_copy_only=zero_copy_only)
        return np_values.reshape((len(self),) + self.type.shape)

    def to_pylist(self, *args, **kwargs):
        # Lists of ndarrays (matches the reference's row view of tensor
        # cells). Signature-compatible with pa.Array.to_pylist (arrow
        # passes maps_as_pydicts through Table.to_pylist).
        return list(self.to_numpy(zero_copy_only=False))


def _register() -> None:
    try:
        pa.register_extension_type(
            ArrowTensorType((0,), pa.float64()))
    except pa.ArrowKeyError:  # pragma: no cover - already registered
        pass


_register()

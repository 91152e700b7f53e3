"""JsonWriter: append SampleBatches to newline-delimited JSON files.

Analog of the reference's rllib/offline/json_writer.py: each line is one
batch with base64-encoded numpy columns, so offline data written by rollout
workers round-trips exactly through JsonReader.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


def _encode_array(arr: np.ndarray) -> Dict[str, Any]:
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": base64.b64encode(np.ascontiguousarray(arr)).decode()}


class JsonWriter:
    def __init__(self, path: str, worker_index: int = 0,
                 max_file_size: int = 64 * 1024 * 1024):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.max_file_size = max_file_size
        self._index = 0
        self._worker_index = worker_index
        self._file = None

    def _rotate(self):
        if self._file is not None:
            self._file.close()
        fname = os.path.join(
            self.path,
            f"output-worker{self._worker_index}-{self._index:05d}.json")
        self._index += 1
        self._file = open(fname, "a")

    def write(self, batch: SampleBatch) -> None:
        if self._file is None or self._file.tell() > self.max_file_size:
            self._rotate()
        row = {k: _encode_array(np.asarray(v)) for k, v in batch.items()}
        self._file.write(json.dumps(row) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

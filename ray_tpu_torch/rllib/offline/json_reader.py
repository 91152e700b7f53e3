"""JsonReader: stream SampleBatches back from JsonWriter output.

Analog of the reference's rllib/offline/json_reader.py: iterates the
``*.json`` files under a directory in round-robin, decoding one batch per
line; ``next()`` cycles forever (offline algorithms sample repeatedly)."""

from __future__ import annotations

import base64
import glob
import json
import os
from typing import List, Optional

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


def _decode_array(spec) -> np.ndarray:
    arr = np.frombuffer(base64.b64decode(spec["data"]),
                        dtype=np.dtype(spec["dtype"]))
    return arr.reshape(spec["shape"]).copy()


class JsonReader:
    def __init__(self, path: str):
        if os.path.isdir(path):
            self.files: List[str] = sorted(
                glob.glob(os.path.join(path, "*.json")))
        else:
            self.files = sorted(glob.glob(path))
        if not self.files:
            raise FileNotFoundError(f"No offline JSON files under {path!r}")
        self._file_idx = 0
        self._lines: Optional[List[str]] = None
        self._line_idx = 0

    def _load_current(self) -> None:
        with open(self.files[self._file_idx]) as f:
            self._lines = [ln for ln in f if ln.strip()]
        self._line_idx = 0

    def next(self) -> SampleBatch:
        if self._lines is None:
            self._load_current()
        while self._line_idx >= len(self._lines):
            self._file_idx = (self._file_idx + 1) % len(self.files)
            self._load_current()
        row = json.loads(self._lines[self._line_idx])
        self._line_idx += 1
        return SampleBatch({k: _decode_array(v) for k, v in row.items()})

    def next_batch(self, batch_size: int, transform=None) -> SampleBatch:
        """Accumulate fragments into an *exact*-size batch: one jitted
        shape for the consumer, no rows dropped — the remainder carries
        over to the next call. ``transform`` (optional) enriches each
        fragment as it is read (e.g. MARWIL attaching return columns).
        Shared by the offline learners (BC, MARWIL)."""
        carry = getattr(self, "_carry", None)
        while carry is None or len(carry) < batch_size:
            fragment = self.next()
            if transform is not None:
                fragment = transform(fragment)
            carry = (fragment if carry is None else
                     SampleBatch.concat_samples([carry, fragment]))
        out = carry.slice(0, batch_size)
        self._carry = carry.slice(batch_size, len(carry))
        return out

    def read_all(self) -> SampleBatch:
        """Concatenate every batch in every file (for small datasets)."""
        batches = []
        for fname in self.files:
            with open(fname) as f:
                for ln in f:
                    if ln.strip():
                        row = json.loads(ln)
                        batches.append(SampleBatch(
                            {k: _decode_array(v) for k, v in row.items()}))
        return SampleBatch.concat_samples(batches)

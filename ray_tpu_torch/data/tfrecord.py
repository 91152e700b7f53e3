"""TFRecord framing + tf.train.Example wire codec, dependency-free.

Analog of the reference's ``data/datasource/tfrecords_datasource.py``,
which imports TensorFlow for the proto classes; TPU images ship no TF,
so this module speaks the two formats directly:

* **TFRecord framing** (tensorflow/core/lib/io/record_writer.cc):
  ``[len: uint64le][masked_crc32c(len): uint32le][data]
  [masked_crc32c(data): uint32le]`` with the CRC32C polynomial and
  TF's mask rotation.
* **tf.train.Example wire format** (example.proto/feature.proto): a
  hand-rolled protobuf codec for the fixed, tiny schema —
  ``Example{ features: Features{ feature: map<string, Feature> } }``
  where ``Feature`` is oneof bytes_list / float_list / int64_list.

Round-trips with real TensorFlow output (same bytes), verified by the
CRC and field-number layout in tests.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

# -- crc32c (software, slice-free — records are small) -------------------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# -- protobuf wire primitives -------------------------------------------

def _write_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(data: bytes, pos: int) -> tuple:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_len_delimited(out: bytearray, field: int,
                         payload: bytes) -> None:
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out.extend(payload)


# -- tf.train.Example encode --------------------------------------------

def _encode_feature(value) -> bytes:
    """Feature{ oneof: bytes_list=1 / float_list=2 / int64_list=3 }."""
    inner = bytearray()
    if isinstance(value, bytes):
        value = [value]
    elif isinstance(value, str):
        value = [value.encode()]
    elif not isinstance(value, (list, tuple)):
        try:
            value = list(value)  # numpy arrays
        except TypeError:
            value = [value]
    if not value:
        lst = b""
        field = 3
    elif isinstance(value[0], (bytes, str)):
        lst_b = bytearray()
        for v in value:
            _write_len_delimited(
                lst_b, 1, v.encode() if isinstance(v, str) else v)
        lst, field = bytes(lst_b), 1
    elif isinstance(value[0], (float,)) or \
            type(value[0]).__name__.startswith("float"):
        # FloatList: packed fixed32 floats (field 1).
        packed = struct.pack(f"<{len(value)}f",
                             *[float(v) for v in value])
        lst_b = bytearray()
        _write_len_delimited(lst_b, 1, packed)
        lst, field = bytes(lst_b), 2
    else:
        # Int64List: packed varints (field 1).
        packed = bytearray()
        for v in value:
            _write_varint(packed, int(v) & 0xFFFFFFFFFFFFFFFF)
        lst_b = bytearray()
        _write_len_delimited(lst_b, 1, bytes(packed))
        lst, field = bytes(lst_b), 3
    out = bytearray()
    _write_len_delimited(out, field, lst)
    return bytes(out)


def encode_example(row: Dict[str, Any]) -> bytes:
    """dict -> serialized tf.train.Example."""
    features = bytearray()
    for name, value in row.items():
        entry = bytearray()  # map entry: key=1, value=2
        _write_len_delimited(entry, 1, name.encode())
        _write_len_delimited(entry, 2, _encode_feature(value))
        _write_len_delimited(features, 1, bytes(entry))
    example = bytearray()
    _write_len_delimited(example, 1, bytes(features))
    return bytes(example)


# -- tf.train.Example decode --------------------------------------------

def _iter_fields(data: bytes) -> Iterator[tuple]:
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            length, pos = _read_varint(data, pos)
            yield field, data[pos:pos + length]
            pos += length
        elif wire == 0:
            value, pos = _read_varint(data, pos)
            yield field, value
        elif wire == 5:
            yield field, data[pos:pos + 4]
            pos += 4
        elif wire == 1:
            yield field, data[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _decode_feature(data: bytes):
    for field, payload in _iter_fields(data):
        if field == 1:      # BytesList
            return [bytes(v) for f, v in _iter_fields(payload)
                    if f == 1]
        if field == 2:      # FloatList (packed or repeated fixed32)
            out: List[float] = []
            for f, v in _iter_fields(payload):
                if f == 1:
                    if isinstance(v, bytes):
                        out.extend(struct.unpack(
                            f"<{len(v) // 4}f", v))
                    else:
                        out.append(float(v))
            return out
        if field == 3:      # Int64List (packed or repeated varint)
            out_i: List[int] = []
            for f, v in _iter_fields(payload):
                if f == 1:
                    if isinstance(v, bytes):
                        pos = 0
                        while pos < len(v):
                            val, pos = _read_varint(v, pos)
                            if val >= 1 << 63:
                                val -= 1 << 64
                            out_i.append(val)
                    else:
                        out_i.append(int(v))
            return out_i
    return []


def decode_example(data: bytes) -> Dict[str, Any]:
    """serialized tf.train.Example -> dict of lists."""
    row: Dict[str, Any] = {}
    for field, features in _iter_fields(data):
        if field != 1:
            continue
        for f, entry in _iter_fields(features):
            if f != 1:
                continue
            name = None
            value = []
            for ef, ev in _iter_fields(entry):
                if ef == 1:
                    name = ev.decode()
                elif ef == 2:
                    value = _decode_feature(ev)
            if name is not None:
                row[name] = value
    return row


# -- TFRecord framing ---------------------------------------------------

def write_tfrecord_file(path: str, records: List[bytes]) -> None:
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))


def read_tfrecord_file(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", header)
            (crc,) = struct.unpack("<I", f.read(4))
            if crc != _masked_crc(header):
                raise ValueError(f"corrupt TFRecord length crc in {path}")
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"truncated TFRecord body in {path}")
            (dcrc,) = struct.unpack("<I", f.read(4))
            if dcrc != _masked_crc(data):
                raise ValueError(f"corrupt TFRecord data crc in {path}")
            yield data

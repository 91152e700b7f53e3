"""Per-rank sharded train checkpoints with two-phase commit + reshard.

A copy of ``ray_tpu/train/_internal/sharded_checkpoint.py`` (the port
imports nothing of ``ray_tpu``), with its on-disk format unchanged: the
same file names, manifest keys, shard layout (C-order numpy blocks sorted
by path) and per-block crc32, so a checkpoint either package writes, the
other restores. What differs: a spec may be the port's
``parallel.sharding.PartitionSpec``, the shard math is the port's copy
(``ray_tpu_torch.parallel.sharding``), and
:meth:`ShardedCheckpoint.restore_on_mesh` places blocks as DTensors on a
``DeviceMesh``. Turning the port's train state into this tree and back is
``ray_tpu_torch.train.torch.checkpoint``'s.

The t5x/Orbax-shaped answer to the single-writer checkpoint bottleneck:
the GSPMD layout that shards parameters across the mesh also shards the
*checkpoint* across ranks. Each rank persists only its local
parameter/optimizer blocks through a spill backend
(``train-<run>-ckpt-<seq>.shard-<rank>`` files, N parallel crash-safe
writes), and the save commits in two phases:

1. every rank writes its shard (atomic tmp → fsync → rename through
   :mod:`ray_tpu_torch._private.spill`) and acks it to the committing
   process (rank 0 of the process group in the port);
2. only after ALL shard acks does that process write the **manifest**
   (``train-<run>-ckpt-<seq>.manifest`` — param tree structure, per-param
   spec, mesh shape, shard → file map with per-block byte offsets and
   crc32 checksums).

The manifest IS the commit record: a rank SIGKILLed mid-save can never
leave a torn checkpoint, because a shard set without a manifest is
invisible to ``CheckpointManager.latest()`` and garbage-collected on
the next index load (``_gc_orphans``).

Resharding: block boundaries are balanced ``array_split`` bounds
(:func:`ray_tpu_torch.parallel.sharding.axis_split_bounds`), so a checkpoint
saved on 8 ranks restores onto 6 or 4 without divisibility constraints —
:meth:`ShardedCheckpoint.load_for_rank` computes the new rank's index
block per parameter and pulls only the overlapping **byte ranges** from
each saved shard (``SpillBackend.read_range``; a contiguous-rows fast
path when only dim 0 is sharded), reassembling arrays that are
numerically identical to the originals.
"""

from __future__ import annotations

import json
import logging
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch._private import chaos, spill
from ray_tpu_torch._private.ray_config import runtime_config_value
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.parallel.sharding import (axis_split_bounds,  # noqa: F401
                                             shard_slices, slices_overlap)

logger = logging.getLogger("ray_tpu_torch.train")

MANIFEST_FORMAT = "ray_tpu-sharded-ckpt-v1"

#: axes_items: ordered [(mesh_axis_name, size), ...]; rank -> coords is
#: row-major over this order, matching Mesh device enumeration.
AxesItems = Sequence[Tuple[str, int]]


def _shard_parallelism() -> int:
    return max(1, int(runtime_config_value("train_ckpt_shard_parallelism",
                                           8)))


def verify_checksums_default() -> bool:
    return bool(runtime_config_value("train_ckpt_verify_checksums", True))


# ---------------------------------------------------------------------------
# File naming
# ---------------------------------------------------------------------------


def ckpt_prefix(run: str) -> str:
    return f"train-{run}-ckpt-"


def shard_filename(run: str, seq: int, rank: int) -> str:
    return f"train-{run}-ckpt-{seq:06d}.shard-{rank:04d}"


def manifest_filename(run: str, seq: int) -> str:
    return f"train-{run}-ckpt-{seq:06d}.manifest"


def is_shard_file(name: str) -> bool:
    return ".shard-" in name


def is_manifest_file(name: str) -> bool:
    return name.endswith(".manifest")


# ---------------------------------------------------------------------------
# Pytree flatten/unflatten (JSON-serializable structure skeleton)
# ---------------------------------------------------------------------------


def flatten_tree(tree: Any) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Flatten a nested dict/list/tuple of array leaves into
    ``{"a/b/0": leaf}`` plus a JSON skeleton that rebuilds the exact
    container types (dict keys are coerced to str)."""
    flat: Dict[str, Any] = {}

    def rec(node: Any, path: Tuple[str, ...]) -> Dict[str, Any]:
        if isinstance(node, dict):
            return {"kind": "dict",
                    "children": {str(k): rec(node[k], path + (str(k),))
                                 for k in sorted(node, key=str)}}
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return {"kind": kind,
                    "children": [rec(v, path + (str(i),))
                                 for i, v in enumerate(node)]}
        flat["/".join(path)] = node
        return {"kind": "leaf"}

    structure = rec(tree, ())
    return flat, structure


def flatten_like(structure: Dict[str, Any], tree: Any) -> Dict[str, Any]:
    """The nodes of ``tree`` at the leaves of ``structure`` (a
    :func:`flatten_tree` skeleton), by path: flattens a tree of the same
    shape whose leaves are themselves tuples, such as PartitionSpecs."""
    flat: Dict[str, Any] = {}

    def rec(skel: Dict[str, Any], node: Any, path: Tuple[str, ...]) -> None:
        if skel["kind"] == "leaf":
            flat["/".join(path)] = node
        elif skel["kind"] == "dict":
            for k, c in skel["children"].items():
                rec(c, node[k], path + (k,))
        else:
            for i, c in enumerate(skel["children"]):
                rec(c, node[i], path + (str(i),))

    rec(structure, tree, ())
    return flat


def unflatten_tree(structure: Dict[str, Any],
                   flat: Dict[str, Any]) -> Any:
    def rec(skel: Dict[str, Any], path: Tuple[str, ...]) -> Any:
        kind = skel["kind"]
        if kind == "leaf":
            return flat["/".join(path)]
        if kind == "dict":
            return {k: rec(c, path + (k,))
                    for k, c in skel["children"].items()}
        vals = [rec(c, path + (str(i),))
                for i, c in enumerate(skel["children"])]
        return vals if kind == "list" else tuple(vals)

    return rec(structure, ())


# ---------------------------------------------------------------------------
# Specs / mesh coordinates
# ---------------------------------------------------------------------------


def normalize_spec(spec: Any, ndim: int) -> List[List[str]]:
    """Per-dim spec entry → list of mesh axis names (JSON form).
    Accepts the port's ``PartitionSpec`` (whose entries are those of
    ``jax.sharding.PartitionSpec``), a tuple/list, or None (fully
    replicated)."""
    entries = list(spec) if spec is not None else []
    out: List[List[str]] = []
    for d in range(ndim):
        e = entries[d] if d < len(entries) else None
        if e is None:
            out.append([])
        elif isinstance(e, str):
            out.append([e])
        else:
            out.append([str(a) for a in e])
    return out


def default_specs(flat: Dict[str, Any], axis: str = "fsdp"
                  ) -> Dict[str, List[List[str]]]:
    """FSDP-style default: shard dim 0 of every >=1-d leaf over ``axis``
    (the ZeRO-3 analog); scalars stay replicated."""
    specs = {}
    for path, leaf in flat.items():
        ndim = np.asarray(leaf).ndim
        specs[path] = [[axis] if d == 0 else [] for d in range(ndim)]
    return specs


def rank_coords(rank: int, axes_items: AxesItems) -> Dict[str, int]:
    """Row-major rank → per-axis mesh coordinates."""
    sizes = [int(s) for _, s in axes_items]
    idx = list(np.unravel_index(rank, sizes)) if sizes else []
    return {name: int(i) for (name, _), i in zip(axes_items, idx)}


def world_size_of(axes_items: AxesItems) -> int:
    n = 1
    for _, s in axes_items:
        n *= int(s)
    return n


def extract_local_shard(flat: Dict[str, Any],
                        specs: Dict[str, Any],
                        axes_items: AxesItems,
                        rank: int) -> Dict[str, np.ndarray]:
    """This rank's index block of every leaf (C-contiguous copies).
    The port's ranks hold their blocks already (``to_local()``) and write
    them directly; this slices a whole tree, as one process holding all
    of it does."""
    axes = dict(axes_items)
    coords = rank_coords(rank, axes_items)
    out = {}
    for path, leaf in flat.items():
        a = np.asarray(leaf)
        spec = normalize_spec(specs.get(path), a.ndim)
        block = a[shard_slices(a.shape, spec, axes, coords)]
        # ascontiguousarray promotes 0-d to (1,); keep scalar shapes.
        out[path] = np.ascontiguousarray(block).reshape(np.shape(block))
    return out


# ---------------------------------------------------------------------------
# Shard write (runs in the rank's worker process)
# ---------------------------------------------------------------------------


def write_shard(backend: spill.SpillBackend, run: str, seq: int, rank: int,
                local_flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """One rank's crash-safe shard write. The shard file is the pure
    concatenation of C-order blocks (one per leaf, sorted by path); all
    metadata — offsets, shapes, checksums — rides the returned record
    into the manifest, so a byte-range reader never parses the file.

    Chaos sites: ``train.ckpt_shard_write_error`` (``io_oserror`` —
    surfaces as :class:`spill.SpillFailure`, failing this save attempt
    cleanly) and ``train.ckpt_shard_kill`` (``kill`` — the SIGKILL-mid-
    save stand-in; :class:`chaos.ChaosKill` propagates so the rank can
    play dead with its shard unwritten).
    """
    blocks: Dict[str, Dict[str, Any]] = {}
    parts: List[bytes] = []
    offset = 0
    file_crc = 0
    for path in sorted(local_flat):
        a = np.ascontiguousarray(np.asarray(local_flat[path]))
        raw = a.tobytes()
        blocks[path] = {
            "offset": offset,
            "length": len(raw),
            "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
            "shape": [int(s) for s in a.shape],
            "dtype": str(a.dtype),
        }
        parts.append(raw)
        file_crc = zlib.crc32(raw, file_crc)
        offset += len(raw)
    filename = shard_filename(run, seq, rank)
    t0 = time.perf_counter()
    try:
        if chaos.ACTIVE:
            chaos.maybe_inject("train.ckpt_shard_kill")
            chaos.maybe_inject("train.ckpt_shard_write_error")
    except chaos.ChaosKill:
        raise
    except OSError as exc:
        raise spill.SpillFailure(
            f"shard write of {filename} failed: {exc}") from exc
    uri = backend.write(filename, parts)
    elapsed = time.perf_counter() - t0
    try:
        from ray_tpu_torch._private import builtin_metrics
        builtin_metrics.train_ckpt_shard_bytes().inc(
            offset, tags={"rank": str(rank)})
    except Exception:  # noqa: BLE001 - accounting never breaks a save
        pass
    return {"seq": int(seq), "rank": int(rank), "file": filename,
            "uri": uri, "bytes": offset,
            "crc32": file_crc & 0xFFFFFFFF, "blocks": blocks,
            "write_s": round(elapsed, 6)}


def build_tree_meta(flat: Dict[str, Any], structure: Dict[str, Any],
                    specs: Dict[str, Any], axes_items: AxesItems,
                    extra: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The global (rank-independent) half of a manifest; identical on
    every rank, so the commit takes rank 0's copy."""
    params = {}
    norm_specs = {}
    for path, leaf in flat.items():
        a = np.asarray(leaf)
        params[path] = {"shape": [int(s) for s in a.shape],
                        "dtype": str(a.dtype)}
        norm_specs[path] = normalize_spec(specs.get(path), a.ndim)
    return {
        "mesh": [[name, int(size)] for name, size in axes_items],
        "world_size": world_size_of(axes_items),
        "params": params,
        "specs": norm_specs,
        "structure": structure,
        "extra": dict(extra or {}),
    }


# ---------------------------------------------------------------------------
# Manifest (the commit record — written LAST, by the committing process)
# ---------------------------------------------------------------------------


def build_manifest(run: str, seq: int, tree_meta: Dict[str, Any],
                   shard_records: List[Dict[str, Any]]) -> Dict[str, Any]:
    shards = sorted(
        ({k: rec[k] for k in ("rank", "file", "bytes", "crc32", "blocks")}
         for rec in shard_records), key=lambda r: r["rank"])
    manifest = {"format": MANIFEST_FORMAT, "run": run, "seq": int(seq)}
    manifest.update(tree_meta)
    manifest["shards"] = shards
    return manifest


def write_manifest(backend: spill.SpillBackend, run: str, seq: int,
                   manifest: Dict[str, Any]) -> str:
    return backend.write(manifest_filename(run, seq),
                         json.dumps(manifest).encode())


def read_manifest(uri: str) -> Optional[Dict[str, Any]]:
    raw = spill.read_uri(uri)
    if raw is None:
        return None
    try:
        manifest = json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError):
        return None
    if manifest.get("format") != MANIFEST_FORMAT:
        return None
    return manifest


def validate_shards(backend: spill.SpillBackend,
                    manifest: Dict[str, Any],
                    verify_checksums: bool) -> bool:
    """Are all of a manifest's shard files present, full-size, and
    (optionally) checksum-clean? Drives orphan-GC adoption/removal of
    manifests whose index entry was lost."""
    for shard in manifest.get("shards", []):
        uri = backend.uri_for(shard["file"])
        size = backend.size_of(uri)
        if size is None or size < int(shard["bytes"]):
            return False
        if verify_checksums:
            data = backend.read(uri, expected_size=int(shard["bytes"]))
            if data is None or \
                    (zlib.crc32(data) & 0xFFFFFFFF) != int(shard["crc32"]):
                return False
    return True


# ---------------------------------------------------------------------------
# The restore/reshard handle
# ---------------------------------------------------------------------------


class ShardedCheckpoint(Checkpoint):
    """A committed sharded checkpoint: a manifest plus byte-range access
    to its shard files. Cheap to ship to every rank of a (re)started
    gang — nothing is read until ``load_for_rank``/``load_full``.

    ``to_dict()`` returns the small user ``extra`` dict (step counters
    etc.); parameter state comes back through :meth:`load_for_rank`
    (the rank's block under the NEW mesh — the reshard path when the
    gang shrank or grew) or :meth:`load_full`.
    """

    def __init__(self, manifest: Dict[str, Any], uri: str):
        super().__init__(uri=uri)
        self.manifest = manifest

    @classmethod
    def from_manifest_uri(cls, uri: str) -> "ShardedCheckpoint":
        manifest = read_manifest(uri)
        if manifest is None:
            raise ValueError(
                f"no readable sharded-checkpoint manifest at {uri}")
        return cls(manifest, uri)

    # -- metadata ---------------------------------------------------------

    @property
    def seq(self) -> int:
        return int(self.manifest["seq"])

    @property
    def world_size(self) -> int:
        return int(self.manifest["world_size"])

    @property
    def mesh_axes(self) -> List[Tuple[str, int]]:
        return [(name, int(size)) for name, size in self.manifest["mesh"]]

    @property
    def extra(self) -> Dict[str, Any]:
        return dict(self.manifest.get("extra", {}))

    def to_dict(self) -> Dict[str, Any]:
        return self.extra

    @property
    def extra_metadata(self) -> Dict[str, Any]:
        return self.extra

    def _hydrate(self) -> None:
        raise ValueError(
            "sharded checkpoints have no monolithic payload; restore "
            "state with load_for_rank()/load_full()")

    _payload_bytes = _hydrate

    # -- restore / reshard ------------------------------------------------

    def _new_axes(self, world_size: Optional[int],
                  axes_items: Optional[AxesItems]) -> List[Tuple[str, int]]:
        if axes_items is not None:
            return [(n, int(s)) for n, s in axes_items]
        old = self.mesh_axes
        if world_size is None or world_size == self.world_size:
            return old
        sharded = [n for n, s in old if s > 1]
        if len(sharded) > 1:
            raise ValueError(
                f"cannot infer a {world_size}-rank mesh from saved axes "
                f"{old}: more than one sharded axis — pass axes_items")
        axis = sharded[0] if sharded else (old[0][0] if old else "fsdp")
        return [(n, world_size if n == axis else 1) for n, s in old] or \
            [(axis, world_size)]

    def load_for_rank(self, rank: int, world_size: Optional[int] = None,
                      axes_items: Optional[AxesItems] = None,
                      verify: Optional[bool] = None) -> Any:
        """This rank's local state under the NEW mesh: per parameter,
        compute the rank's index block and pull only the overlapping
        byte ranges from the saved shards. world_size == saved world is
        a plain per-rank reload; anything else is a reshard."""
        new_axes = self._new_axes(world_size, axes_items)
        if world_size is not None and world_size_of(new_axes) != world_size:
            raise ValueError(
                f"axes {new_axes} describe {world_size_of(new_axes)} "
                f"ranks, not {world_size}")
        return self._load_local(new_axes, rank, verify)

    def load_full(self, verify: Optional[bool] = None) -> Any:
        """The whole tree, reassembled (rank 0 of a 1-rank mesh)."""
        axes = [(name, 1) for name, _ in self.mesh_axes] or [("fsdp", 1)]
        return self._load_local(axes, 0, verify)

    def restore_on_mesh(self, mesh, rules=None, spec_tree=None) -> Any:
        """Reassemble and place on a ``DeviceMesh`` — the single-controller
        reshard path (ranks that keep the saved specs use
        ``load_for_rank`` and place their own block). Every rank reads the
        whole tree, takes its block under ``spec_tree`` (a tree of specs
        of the checkpoint's structure; default the saved specs) at its
        mesh coordinates, and wraps it as a DTensor on ``mesh`` with no
        communication, in the placements ``parallel.sharding.placements``
        gives. The counterpart of the JAX package's ``device_put`` under
        the new shardings. ``rules`` is unused, as in the JAX package: the
        specs come from ``spec_tree`` or the manifest."""
        import torch
        from torch.distributed.tensor import DTensor

        from ray_tpu_torch.parallel.mesh import mesh_sizes
        from ray_tpu_torch.parallel.sharding import placements
        del rules
        flat, _ = flatten_tree(self.load_full())
        if spec_tree is None:
            specs = dict(self.manifest["specs"])
        else:
            specs = flatten_like(self.manifest["structure"], spec_tree)
        sizes = mesh_sizes(mesh)
        coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        out = {}
        for path, whole in flat.items():
            spec = normalize_spec(specs.get(path), whole.ndim)
            for size, axes in zip(whole.shape, spec):
                n = int(np.prod([sizes[a] for a in axes]))
                if size % n:
                    raise ValueError(
                        f"{path}: a dim of size {size} does not split evenly "
                        f"over {axes} ({n} blocks); DTensor's blocks are "
                        f"even")
            block = whole[shard_slices(whole.shape, spec, sizes, coords)]
            local = torch.from_numpy(np.ascontiguousarray(block).reshape(
                block.shape)).to(mesh.device_type)
            out[path] = DTensor.from_local(
                local, mesh, placements(mesh, spec), run_check=False,
                shape=torch.Size(whole.shape),
                stride=torch.empty(whole.shape, device="meta").stride())
        return unflatten_tree(self.manifest["structure"], out)

    # -- internals --------------------------------------------------------

    def _load_local(self, new_axes: List[Tuple[str, int]], rank: int,
                    verify: Optional[bool]) -> Any:
        verify = verify_checksums_default() if verify is None else verify
        backend = spill.reader_for_uri(self._uri)
        if backend is None:
            raise ValueError(f"no spill backend can read {self._uri}")
        manifest = self.manifest
        old_axes = self.mesh_axes
        axes = dict(new_axes)
        coords = rank_coords(rank, new_axes)
        old_coord_cache = {s["rank"]: rank_coords(s["rank"], old_axes)
                           for s in manifest["shards"]}
        t0 = time.perf_counter()

        def load_param(path: str) -> np.ndarray:
            meta = manifest["params"][path]
            shape = tuple(meta["shape"])
            dtype = np.dtype(meta["dtype"])
            spec = manifest["specs"][path]
            sel = shard_slices(shape, spec, axes, coords)
            out = np.empty(tuple(s.stop - s.start for s in sel), dtype)
            for shard in manifest["shards"]:
                old_sl = shard_slices(shape, spec, dict(old_axes),
                                      old_coord_cache[shard["rank"]])
                ov = slices_overlap(sel, old_sl)
                if ov is None:
                    continue
                block = shard["blocks"][path]
                local_shape = tuple(s.stop - s.start for s in old_sl)
                uri = backend.uri_for(shard["file"])
                dest = tuple(slice(o.start - s.start, o.stop - s.start)
                             for o, s in zip(ov, sel))
                src = tuple(slice(o.start - s.start, o.stop - s.start)
                            for o, s in zip(ov, old_sl))
                whole = all(o == s for o, s in zip(ov, old_sl))
                rows_only = shape and all(
                    o == s for o, s in zip(ov[1:], old_sl[1:]))
                if whole or not rows_only:
                    # Whole block (also the general multi-dim fallback:
                    # read the block, slice in memory).
                    raw = backend.read_range(uri, int(block["offset"]),
                                             int(block["length"]))
                    if raw is None:
                        raise ValueError(
                            f"shard {shard['file']} unreadable for "
                            f"{path} (storage lost after commit?)")
                    if verify and (zlib.crc32(raw) & 0xFFFFFFFF) != \
                            int(block["crc32"]):
                        raise ValueError(
                            f"checksum mismatch in {shard['file']} "
                            f"block {path} — corrupt shard")
                    arr = np.frombuffer(raw, dtype).reshape(local_shape)
                    out[dest] = arr[src]
                else:
                    # Contiguous-rows fast path: only dim 0 differs, so
                    # the overlap is a contiguous byte range.
                    row_bytes = dtype.itemsize * int(
                        np.prod(local_shape[1:], dtype=np.int64))
                    lo = (ov[0].start - old_sl[0].start) * row_bytes
                    nrows = ov[0].stop - ov[0].start
                    raw = backend.read_range(
                        uri, int(block["offset"]) + lo, nrows * row_bytes)
                    if raw is None:
                        raise ValueError(
                            f"shard {shard['file']} unreadable for "
                            f"{path} (storage lost after commit?)")
                    arr = np.frombuffer(raw, dtype).reshape(
                        (nrows,) + local_shape[1:])
                    out[dest] = arr[(slice(None),) + src[1:]]
            return out

        paths = sorted(manifest["params"])
        flat: Dict[str, np.ndarray] = {}
        workers = min(_shard_parallelism(), max(1, len(paths)))
        if workers > 1 and len(paths) > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for path, arr in zip(paths, pool.map(load_param, paths)):
                    flat[path] = arr
        else:
            for path in paths:
                flat[path] = load_param(path)
        try:
            from ray_tpu_torch._private import builtin_metrics
            builtin_metrics.train_ckpt_restore_seconds().observe(
                time.perf_counter() - t0)
        except Exception:  # noqa: BLE001
            pass
        return unflatten_tree(manifest["structure"], flat)

    def __repr__(self):
        return (f"ShardedCheckpoint(id={self.id}, run="
                f"{self.manifest.get('run')!r}, seq={self.seq}, "
                f"world={self.world_size}, source={self._uri})")

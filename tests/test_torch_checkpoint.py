"""The port's sharded checkpoints against the JAX package's.

(a) The gang-free tests of ``tests/test_sharded_checkpoint.py``, on the
port's copies of the shard math, manifest, two-phase commit, orphan GC,
checksums, chaos sites and spill backends (the five tests there that need
the trainer's gang wait for it, ``ROADMAP.md`` queue 1, item 7).

(b) JAX → port: the JAX package trains gpt-micro (and llama-micro) on the
8 fake CPU devices of ``tests/conftest.py`` and writes the checkpoint with
its own ``write_shard``/``build_manifest``/``write_manifest``; the port
restores it with every leaf exactly equal, and its next step agrees with
the JAX package's (the bounds of ``tests/test_torch_train_step.py``).

(c) Port → JAX: the port saves, the JAX package's ``load_full`` reads
every leaf exactly, and the JAX package's next step from it agrees with
the port's.

(e) ``Checkpoint.from_sharded_state``/``restore_sharded_state`` (DCP) in
one process; the ranks' half of (d) and (e) is in
``tests/test_torch_checkpoint_ranks.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JaxSpec

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import MeshConfig, build_mesh, dp_rules, tp_fsdp_rules
from ray_tpu.parallel import train_step as jts
from ray_tpu.train._internal import sharded_checkpoint as jsc
from ray_tpu_torch._private import builtin_metrics, chaos, spill
from ray_tpu_torch.air import Checkpoint, CheckpointConfig
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.parallel.sharding import PartitionSpec
from ray_tpu_torch.train import (CheckpointManager, ShardedCheckpoint,
                                 latest_checkpoint, restore_train_state,
                                 save_train_state)
from ray_tpu_torch.train._internal import sharded_checkpoint as sc
from ray_tpu_torch.train.torch.checkpoint import restore_route

# One step from the same state: the losses and parameters differ only by
# the two frameworks' summation orders (tests/test_torch_train_step.py).
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-6
B, S = 8, 64


def _counter_total(counter):
    return sum(counter.series().values())


def _state_at(step):
    """Deterministic full training state as a function of the step."""
    base = np.arange(13 * 4, dtype=np.float32).reshape(13, 4)
    return {"w": base * float(step + 1),
            "b": np.full((7,), float(step), np.float32),
            "opt": [np.ascontiguousarray(base.T) / float(step + 1),
                    np.float32(step)]}


def _trees_equal(a, b):
    fa, _ = sc.flatten_tree(a)
    fb, _ = sc.flatten_tree(b)
    if set(fa) != set(fb):
        return False
    return all(np.array_equal(np.asarray(fa[p]), np.asarray(fb[p]))
               for p in fa)


def _save_sharded(backend, run, seq, state, world, extra=None):
    """Write all shards + commit a manifest directly (no gang)."""
    flat, structure = sc.flatten_tree(state)
    axes = [("fsdp", world)]
    specs = sc.default_specs(flat)
    records = [
        sc.write_shard(backend, run, seq, rank,
                       sc.extract_local_shard(flat, specs, axes, rank))
        for rank in range(world)
    ]
    meta = sc.build_tree_meta(flat, structure, specs, axes, extra=extra)
    manifest = sc.build_manifest(run, seq, meta, records)
    uri = sc.write_manifest(backend, run, seq, manifest)
    return manifest, uri, records


def _shards(backend, run, seq, state, world):
    flat, structure = sc.flatten_tree(state)
    specs = sc.default_specs(flat)
    records = [sc.write_shard(backend, run, seq, rank,
                              sc.extract_local_shard(flat, specs,
                                                     [("fsdp", world)], rank))
               for rank in range(world)]
    return records, sc.build_tree_meta(flat, structure, specs,
                                       [("fsdp", world)],
                                       extra={"step": seq})


# ---------------------------------------------------------------------------
# (a) Shard math
# ---------------------------------------------------------------------------


def test_axis_split_bounds_balanced():
    assert sc.axis_split_bounds(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    bounds = sc.axis_split_bounds(13, 6)
    assert bounds[0] == (0, 3)
    assert bounds[-1] == (11, 13)
    assert [b - a for a, b in bounds] == [3, 2, 2, 2, 2, 2]
    assert sc.axis_split_bounds(2, 4)[-1] == (2, 2)
    with pytest.raises(ValueError):
        sc.axis_split_bounds(4, 0)


def test_shard_slices_and_overlap():
    axes = {"dp": 2, "fsdp": 2}
    spec = [["dp", "fsdp"], []]
    blocks = [sc.shard_slices((8, 3), spec, axes, {"dp": d, "fsdp": f})
              for d in range(2) for f in range(2)]
    assert [b[0] for b in blocks] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert all(b[1] == slice(0, 3) for b in blocks)
    assert sc.slices_overlap((slice(0, 4),), (slice(2, 6),)) == \
        (slice(2, 4),)
    assert sc.slices_overlap((slice(0, 2),), (slice(2, 6),)) is None
    assert sc.slices_overlap((), ()) == ()


@pytest.mark.parametrize("make_spec", [PartitionSpec, JaxSpec],
                         ids=["port", "jax"])
def test_normalize_spec_accepts_partition_spec(make_spec):
    assert sc.normalize_spec(make_spec("fsdp", None), 2) == [["fsdp"], []]
    assert sc.normalize_spec(make_spec(("dp", "fsdp")), 2) == \
        [["dp", "fsdp"], []]
    assert sc.normalize_spec(None, 2) == [[], []]


# ---------------------------------------------------------------------------
# (a) Manifest round-trip + restore/reshard
# ---------------------------------------------------------------------------


def test_manifest_roundtrip_and_full_restore(tmp_path):
    backend = spill.FileSpillBackend(str(tmp_path))
    state = _state_at(5)
    manifest, uri, records = _save_sharded(backend, "rt", 3, state, 8,
                                           extra={"step": 5})
    assert len(records) == 8
    ck = ShardedCheckpoint.from_manifest_uri(uri)
    assert ck.seq == 3 and ck.world_size == 8
    assert ck.extra == {"step": 5}
    assert ck.to_dict() == {"step": 5}
    restored = ck.load_full()
    assert _trees_equal(restored, state)
    assert isinstance(restored, dict) and isinstance(restored["opt"], list)
    with pytest.raises(ValueError, match="load_for_rank"):
        ck.to_directory()


@pytest.mark.parametrize("new_world", [6, 4])
def test_reshard_numerical_identity(tmp_path, new_world):
    backend = spill.FileSpillBackend(str(tmp_path))
    state = _state_at(2)
    manifest, uri, _ = _save_sharded(backend, "rs", 1, state, 8)
    ck = ShardedCheckpoint.from_manifest_uri(uri)
    new_axes = [("fsdp", new_world)]
    reassembled = {p: np.empty(tuple(m["shape"]), np.dtype(m["dtype"]))
                   for p, m in manifest["params"].items()}
    for rank in range(new_world):
        local, _ = sc.flatten_tree(ck.load_for_rank(rank, new_world))
        coords = sc.rank_coords(rank, new_axes)
        for p, arr in local.items():
            slc = sc.shard_slices(tuple(manifest["params"][p]["shape"]),
                                  manifest["specs"][p], dict(new_axes),
                                  coords)
            reassembled[p][slc] = arr
    flat, _ = sc.flatten_tree(state)
    for p in flat:
        assert np.array_equal(np.asarray(flat[p]), reassembled[p]), p


def _corrupt(backend, record, fill):
    victim = backend.path_for(backend.uri_for(record["file"]))
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        f.seek(size // 2)
        f.write(fill)


def test_checksum_rejection(tmp_path):
    backend = spill.FileSpillBackend(str(tmp_path))
    _, uri, records = _save_sharded(backend, "crc", 1, _state_at(0), 2)
    _corrupt(backend, records[1], b"\xff\xff\xff\xff")
    ck = ShardedCheckpoint.from_manifest_uri(uri)
    with pytest.raises(ValueError, match="checksum"):
        ck.load_full(verify=True)


# ---------------------------------------------------------------------------
# (a) Two-phase commit: visibility, orphan GC, adoption, pruning
# ---------------------------------------------------------------------------


def test_uncommitted_shards_invisible_and_gcd(tmp_path):
    """Shard files without a manifest are invisible to latest() and swept
    by the next index load (the port emits no event: it has no runtime)."""
    mgr = CheckpointManager(str(tmp_path), "torn")
    backend = mgr._backend
    _shards(backend, "torn", 1, _state_at(1), 2)  # no manifest
    assert mgr.latest() is None
    assert len(backend.list_files("train-torn-ckpt-")) == 2
    orphans_before = _counter_total(builtin_metrics.train_ckpt_orphans_gc())
    mgr2 = CheckpointManager(str(tmp_path), "torn")
    assert mgr2.latest() is None
    assert backend.list_files("train-torn-ckpt-") == []
    assert _counter_total(builtin_metrics.train_ckpt_orphans_gc()) >= \
        orphans_before + 2


def test_corrupt_shard_uncommits_manifest_on_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "bitrot")
    backend = mgr._backend
    _save_sharded(backend, "bitrot", 1, _state_at(0), 2)
    _, _, records = _save_sharded(backend, "bitrot", 2, _state_at(1), 2)
    _corrupt(backend, records[0], b"\x00\x00\x00\x00")
    latest = CheckpointManager(str(tmp_path), "bitrot").latest()
    assert isinstance(latest, ShardedCheckpoint)
    assert latest.seq == 1
    names = backend.list_files("train-bitrot-ckpt-")
    assert not any("000002" in n for n in names), names


def test_committed_manifest_adopted_into_index(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "adopt")
    _save_sharded(mgr._backend, "adopt", 4, _state_at(3), 2,
                  extra={"step": 3})
    mgr2 = CheckpointManager(str(tmp_path), "adopt")
    latest = mgr2.latest()
    assert isinstance(latest, ShardedCheckpoint)
    assert latest.seq == 4 and latest.extra == {"step": 3}
    assert mgr2.next_seq_base() == 5
    assert _trees_equal(latest.load_full(), _state_at(3))


def test_register_sharded_commits_and_prunes_all_files(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "prune",
                            CheckpointConfig(num_to_keep=1))
    backend = mgr._backend
    for seq in (1, 2):
        records, meta = _shards(backend, "prune", seq, _state_at(seq), 2)
        assert isinstance(mgr.register_sharded(seq, meta, records),
                          ShardedCheckpoint)
    names = backend.list_files("train-prune-ckpt-")
    assert all("000002" in n for n in names), names
    assert len(names) == 3, names
    latest = mgr.latest()
    assert latest.seq == 2
    assert _trees_equal(latest.load_full(), _state_at(2))


def test_register_sharded_refuses_partial_gang(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "partial")
    records, meta = _shards(mgr._backend, "partial", 1, _state_at(0), 2)
    with pytest.raises(ValueError, match="contiguous"):
        mgr.register_sharded(1, meta, records[1:])  # rank 0 missing


def test_chaos_io_oserror_fails_write_keeps_prior(tmp_path):
    backend = spill.FileSpillBackend(str(tmp_path))
    _, uri, _ = _save_sharded(backend, "io", 1, _state_at(7), 2,
                              extra={"step": 7})
    flat, _ = sc.flatten_tree(_state_at(8))
    specs = sc.default_specs(flat)
    chaos.configure("io_oserror:site=train.ckpt_shard_write_error:times=1")
    try:
        with pytest.raises(spill.SpillFailure):
            sc.write_shard(backend, "io", 2, 0,
                           sc.extract_local_shard(flat, specs,
                                                  [("fsdp", 2)], 0))
    finally:
        chaos.reset()
    prior = ShardedCheckpoint.from_manifest_uri(uri)
    assert _trees_equal(prior.load_full(), _state_at(7))


def test_mock_s3_backend_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_MOCK_S3_DIR", str(tmp_path / "s3"))
    mgr = CheckpointManager("mock-s3://ckpt-bucket", "cloudy")
    records, meta = _shards(mgr._backend, "cloudy", 1, _state_at(1), 2)
    handle = mgr.register_sharded(1, meta, records)
    assert handle.uri.startswith("mock-s3://ckpt-bucket/")
    latest = CheckpointManager("mock-s3://ckpt-bucket", "cloudy").latest()
    assert isinstance(latest, ShardedCheckpoint)
    assert _trees_equal(latest.load_full(), _state_at(1))


def test_config_knobs_present():
    """The port's defaults are the JAX package's, under the same names."""
    from ray_tpu._private import ray_config as jconfig
    from ray_tpu_torch._private.ray_config import _PY_DEFAULTS
    assert _PY_DEFAULTS["train_ckpt_shard_parallelism"] == 8
    assert _PY_DEFAULTS["train_ckpt_verify_checksums"] is True
    assert all(jconfig._PY_DEFAULTS[k] == v for k, v in _PY_DEFAULTS.items())


def test_shard_parallelism_one_still_loads(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_train_ckpt_shard_parallelism", "1")
    backend = spill.FileSpillBackend(str(tmp_path))
    _, uri, _ = _save_sharded(backend, "serial", 1, _state_at(4), 4)
    assert _trees_equal(ShardedCheckpoint.from_manifest_uri(uri).load_full(),
                        _state_at(4))


def test_session_backend_takes_its_id_from_the_uri(tmp_path, monkeypatch):
    """``session://<id>`` names its session; a bare ``session://`` takes
    the running runtime's, as the JAX package's manager does (the port's
    is its copy), and raises with no runtime up, which building a manager
    does not start."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    mgr = CheckpointManager("session://s1", "sess")
    records, meta = _shards(mgr._backend, "sess", 1, _state_at(2), 2)
    handle = mgr.register_sharded(1, meta, records)
    assert handle.uri.startswith("session://s1/")
    assert _trees_equal(ShardedCheckpoint.from_manifest_uri(
        handle.uri).load_full(), _state_at(2))
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker
    ray_tpu_torch.shutdown()
    with pytest.raises(ValueError, match="session id"):
        CheckpointManager("session://", "sess")
    assert global_worker._runtime is None
    ray_tpu_torch.init(num_cpus=1, num_gpus=0)
    try:
        sid = global_worker.runtime.session_id
        assert sid
        assert CheckpointManager("session://", "sess")._backend.session_id \
            == sid
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# The port's train state <-> the JAX package's tree
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adamw": lambda m: m.default_optimizer(1e-3, warmup_steps=1),
    "adafactor": lambda m: m.memory_efficient_optimizer(1e-2,
                                                        warmup_steps=1),
}
MODELS = {"gpt": (jgpt, tgpt, "gpt-micro"),
          "gpt-moe": (jgpt, tgpt, "gpt-moe-tiny"),
          "llama": (jllama, tllama, "llama-micro")}


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _port_state(model_name, opt_name, seed):
    """The port's train state of a fresh model (weights from ``seed``)."""
    _, tmod, preset = MODELS[model_name]
    cfg = tmod.config(preset)
    opt = OPTIMIZERS[opt_name](tts)
    if model_name != "llama":
        return tts.init_train_state(cfg, optimizer=opt, seed=seed,
                                    device="cpu"), opt
    model = tmod.init(cfg, torch.Generator().manual_seed(seed), "cpu")
    return {"params": model,
            "opt_state": opt.init(dict(model.named_parameters()),
                                  tmod.leaf_groups(model)),
            "step": torch.zeros((), dtype=torch.int32)}, opt


def _port_step(model_name, opt, state, batch):
    """One step of the port (GPT: its train step; Llama: loss_fn, grads,
    update, as README composes it) → (state, loss)."""
    _, tmod, _ = MODELS[model_name]
    model = state["params"]
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    if model_name != "llama":
        state, m = tts.make_train_step(model.cfg, optimizer=opt)(state, b)
        return state, float(m["loss"])
    named = dict(model.named_parameters())
    loss, m = tmod.loss_fn(model, b["tokens"], b["targets"])
    grads = torch.autograd.grad(loss, list(named.values()))
    with torch.no_grad():
        updates, opt_state = opt.update(dict(zip(named, grads)),
                                        state["opt_state"], named)
        optim.apply_updates(named, updates)
    return ({"params": model, "opt_state": opt_state,
             "step": state["step"] + 1}, float(m["loss"]))


def _port_flat(state):
    """The port's state in the JAX layout, flattened, as numpy."""
    model = state["params"]
    groups = tgpt.leaf_groups(model)
    tree = {"params": optim.to_jax_tree(dict(model.named_parameters()),
                                        groups, "cpu"),
            "opt_state": optim.to_optax_state(state["opt_state"], groups,
                                              "cpu"),
            "step": state["step"]}
    flat, structure = sc.flatten_tree(tree)
    return {p: v.detach().numpy() for p, v in flat.items()}, structure


def _jax_step_fn(model_name, cfg, mesh, jopt):
    """The JAX package's step: its train step for GPT; for Llama (it has
    none) value_and_grad of loss_fn and the optimizer, jitted."""
    if model_name != "llama":
        step = jts.make_train_step(cfg, mesh, tp_fsdp_rules()
                                   if mesh.size > 1 else dp_rules(), jopt)
        return lambda state, b: step(state, {k: jnp.asarray(v)
                                             for k, v in b.items()})

    @jax.jit
    def step(state, b):
        (loss, m), grads = jax.value_and_grad(
            lambda p: jllama.loss_fn(p, cfg, b["tokens"], b["targets"]),
            has_aux=True)(state["params"])
        updates, opt_state = jopt.update(grads, state["opt_state"],
                                         state["params"])
        return ({"params": optax.apply_updates(state["params"], updates),
                 "opt_state": opt_state, "step": state["step"] + 1},
                {"loss": loss})
    return step


def _jax_state_on(mesh, tree, jmod, cfg, jopt, rules):
    """A JAX train state from a checkpoint's tree: parameters placed by
    the model's specs, the optimizer's state rebuilt into optax's own
    types (its leaves are in the same order), replicated."""
    pspecs = jmod.param_specs(cfg, rules)
    params = jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        tree["params"], pspecs)
    rep = NamedSharding(mesh, JaxSpec())
    treedef = jax.tree_util.tree_structure(jopt.init(params))
    opt_state = jax.tree_util.tree_unflatten(
        treedef, [jax.device_put(x, rep)
                  for x in jax.tree_util.tree_leaves(tree["opt_state"])])
    return {"params": params, "opt_state": opt_state,
            "step": jax.device_put(jnp.asarray(tree["step"]), rep)}


def _leaf_spec(x):
    sharding = getattr(x, "sharding", None)
    return sharding.spec if isinstance(sharding, NamedSharding) else None


def _jax_checkpoint(model_name, opt_name, tmp_path):
    """The JAX package on its 8-device mesh (tp_fsdp_rules): its state
    after 2 steps, written as tests/test_sharded_checkpoint.py's
    ``_save_sharded`` writes one (each leaf by its own sharding's spec),
    and its third step → (uri, state tree, third loss, params after)."""
    jmod, _, preset = MODELS[model_name]
    cfg = jmod.config(preset)
    mesh = build_mesh(MeshConfig(dp=2, fsdp=2, tp=2),
                      devices=jax.devices("cpu")[:8])
    jopt = OPTIMIZERS[opt_name](jts)
    with jax.default_matmul_precision("highest"):
        if model_name != "llama":
            state = jts.init_train_state(cfg, mesh, tp_fsdp_rules(), jopt)
        else:
            params = jmod.init(cfg, jax.random.PRNGKey(0))
            state = _jax_state_on(mesh, {"params": params,
                                         "opt_state": jopt.init(params),
                                         "step": np.int32(0)},
                                  jmod, cfg, jopt, tp_fsdp_rules())
        step = _jax_step_fn(model_name, cfg, mesh, jopt)
        for i in range(2):
            state, _ = step(state, _batch(cfg, i))
        specs_tree = jax.tree_util.tree_map(_leaf_spec, state)
        tree = jax.tree_util.tree_map(np.array, state)  # the step donates
        state, m = step(state, _batch(cfg, 2))
        after = jax.tree_util.tree_map(np.asarray, state["params"])
    flat, structure = jsc.flatten_tree(tree)
    specs = sc.flatten_like(structure, specs_tree)
    axes = list(mesh.shape.items())
    backend = spill.FileSpillBackend(str(tmp_path))
    records = [jsc.write_shard(backend, "jax", 1, rank,
                               jsc.extract_local_shard(flat, specs, axes,
                                                       rank))
               for rank in range(8)]
    meta = jsc.build_tree_meta(flat, structure, specs, axes)
    manifest = jsc.build_manifest("jax", 1, meta, records)
    uri = jsc.write_manifest(backend, "jax", 1, manifest)
    return uri, flat, float(m["loss"]), after


def _assert_params_close(model_name, model, want):
    _, tmod, _ = MODELS[model_name]
    got, _ = sc.flatten_tree(tmod.to_jax_params(model))
    want, _ = sc.flatten_tree(want)
    for p, w in want.items():
        np.testing.assert_allclose(got[p], w, atol=PARAM_ATOL,
                                   rtol=STEP_RTOL, err_msg=p)


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_jax_checkpoint_resumes_in_the_port(tmp_path, model_name, opt_name):
    uri, jflat, jloss, jafter = _jax_checkpoint(model_name, opt_name,
                                                tmp_path)
    state, opt = _port_state(model_name, opt_name, seed=5)
    ckpt = ShardedCheckpoint.from_manifest_uri(uri)
    assert restore_route(ckpt, state) == "load_full"
    state = restore_train_state(state, ckpt)
    flat, _ = _port_flat(state)
    assert set(flat) == set(jflat)
    for p, want in jflat.items():
        assert flat[p].dtype == want.dtype, p
        np.testing.assert_array_equal(flat[p], want, err_msg=p)
    state, loss = _port_step(model_name, opt, state,
                             _batch(state["params"].cfg, 2))
    np.testing.assert_allclose(loss, jloss, rtol=STEP_RTOL)
    _assert_params_close(model_name, state["params"], jafter)
    assert int(state["step"]) == 3


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_port_checkpoint_resumes_in_jax(tmp_path, model_name, opt_name):
    state, opt = _port_state(model_name, opt_name, seed=3)
    cfg = state["params"].cfg
    for i in range(2):
        state, _ = _port_step(model_name, opt, state, _batch(cfg, i))
    mgr = CheckpointManager(str(tmp_path), "port")
    handle = save_train_state(state, mgr, extra={"step": 2})
    assert handle.seq == 1 and handle.extra == {"step": 2}
    assert latest_checkpoint(mgr).uri == handle.uri
    flat, structure = _port_flat(state)
    jckpt = jsc.ShardedCheckpoint.from_manifest_uri(handle.uri)
    assert jckpt.manifest["structure"] == structure
    jflat, _ = jsc.flatten_tree(jckpt.load_full())
    assert set(jflat) == set(flat)
    for p, want in flat.items():
        assert jflat[p].dtype == want.dtype, p
        np.testing.assert_array_equal(jflat[p], want, err_msg=p)

    jmod, _, preset = MODELS[model_name]
    jcfg = jmod.config(preset)
    mesh = build_mesh(MeshConfig(dp=1, fsdp=1, tp=1),
                      devices=jax.devices("cpu")[:1])
    jopt = OPTIMIZERS[opt_name](jts)
    with jax.default_matmul_precision("highest"):
        jstate = _jax_state_on(mesh, jckpt.load_full(), jmod, jcfg, jopt,
                               dp_rules())
        jstate, m = _jax_step_fn(model_name, jcfg, mesh, jopt)(
            jstate, _batch(cfg, 2))
        jafter = jax.tree_util.tree_map(np.asarray, jstate["params"])
    state, loss = _port_step(model_name, opt, state, _batch(cfg, 2))
    np.testing.assert_allclose(loss, float(m["loss"]), rtol=STEP_RTOL)
    _assert_params_close(model_name, state["params"], jafter)


def test_save_refuses_bf16_and_restore_refuses_another_optimizer(tmp_path):
    """A bfloat16 leaf has no numpy dtype and is never cast; a checkpoint
    of one optimizer does not restore into another's state."""
    cfg = tgpt.config("gpt-micro", param_dtype=torch.bfloat16)
    state = tts.init_train_state(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path), "bf16")
    with pytest.raises(TypeError, match="float32 and int32"):
        save_train_state(state, mgr)
    assert mgr._backend.list_files("train-bf16-ckpt-") == []
    state, _ = _port_state("gpt", "adamw", seed=0)
    handle = save_train_state(state, mgr)
    other, _ = _port_state("gpt", "adafactor", seed=0)
    with pytest.raises(ValueError, match="opt_state"):
        restore_train_state(other, handle)


def test_failed_shard_write_commits_nothing(tmp_path):
    """An injected shard-write error: no manifest, None returned, the
    failure counted, and the previous checkpoint still the latest."""
    state, _ = _port_state("gpt", "adafactor", seed=0)
    mgr = CheckpointManager(str(tmp_path), "fail")
    first = save_train_state(state, mgr)
    failures = _counter_total(
        builtin_metrics.train_checkpoint_persist_failures())
    chaos.configure("io_oserror:site=train.ckpt_shard_write_error:times=1")
    try:
        assert save_train_state(state, mgr) is None
    finally:
        chaos.reset()
    assert _counter_total(builtin_metrics.train_checkpoint_persist_failures(
    )) == failures + 1
    assert mgr.latest().uri == first.uri


def test_restore_raises_on_a_corrupt_shard(tmp_path):
    state, _ = _port_state("gpt", "adafactor", seed=0)
    handle = save_train_state(state, CheckpointManager(str(tmp_path), "bad"))
    backend = spill.FileSpillBackend(str(tmp_path))
    _corrupt(backend, handle.manifest["shards"][0], b"\x01\x02\x03\x04")
    with pytest.raises(ValueError, match="checksum"):
        restore_train_state(state, ShardedCheckpoint.from_manifest_uri(
            handle.uri))


# ---------------------------------------------------------------------------
# (e) DCP in one process
# ---------------------------------------------------------------------------


def test_dcp_sharded_state_round_trip_in_one_process(tmp_path):
    state, _ = _port_state("gpt", "adamw", seed=0)
    model = state["params"]
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    ck = Checkpoint.from_sharded_state(
        {"model": model.state_dict(), "step": torch.tensor(7)},
        str(tmp_path / "dcp"), extra={"step": 7})
    assert ck.extra_metadata == {"step": 7}
    with open(tmp_path / "dcp" / "ckpt_metadata.json") as f:
        assert json.load(f)["format"] == "torch.distributed.checkpoint"
    other, _ = _port_state("gpt", "adamw", seed=1)
    target = {"model": other["params"].state_dict(), "step": torch.tensor(0)}
    ck.restore_sharded_state(target)
    assert int(target["step"]) == 7
    for k, v in other["params"].state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_dcp_restore_refuses_the_jax_packages_orbax_directory(tmp_path):
    (tmp_path / "sharded_state").mkdir()
    with open(tmp_path / "ckpt_metadata.json", "w") as f:
        json.dump({"format": "orbax", "extra": {}}, f)
    with pytest.raises(ValueError, match="orbax"):
        Checkpoint.from_directory(str(tmp_path)).restore_sharded_state({})

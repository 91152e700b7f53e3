"""Sharded checkpoints through the gang: ``session.report_sharded`` and the
executor's two-phase commit, on the port's runtime.

Mirrors the gang tests of tests/test_sharded_checkpoint.py (end to end,
a shard write's error, a rank killed mid-save, an elastic shrink, the
reshard veto) on the port's copies with numpy trees. Then the port's own
train state: gpt-micro through ``TorchTrainer`` on one in-process worker,
its committed checkpoint read by the JAX package's ``ShardedCheckpoint``,
held to the JAX package's train step and bit-equal to the worker's own
state, and a resumed run bit-equal to the uninterrupted one; and gpt-micro under ``fsdp_rules()`` on two gloo
worker processes, each writing only its own blocks, with one rank's
failed write leaving the previous checkpoint standing.
"""

import os
import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch

# Train loops run on actor threads and in worker processes, which cannot
# import the tests/ directory: ship this module's functions by value.
cloudpickle.register_pickle_by_value(sys.modules[__name__])

from ray_tpu.models import gpt as jgpt  # noqa: E402
from ray_tpu.parallel import MeshConfig, build_mesh, dp_rules  # noqa: E402
from ray_tpu.parallel import fsdp_rules  # noqa: E402
from ray_tpu.parallel import train_step as jts  # noqa: E402
from ray_tpu.train._internal import sharded_checkpoint as jsc  # noqa: E402
from ray_tpu_torch._private import (builtin_metrics, chaos, events,  # noqa: E402
                                    spill)
from ray_tpu_torch.air import (FailureConfig, RunConfig,  # noqa: E402
                               ScalingConfig, session)
from ray_tpu_torch.train import (DataParallelTrainer,  # noqa: E402
                                 ShardedCheckpoint, TorchTrainer)
from ray_tpu_torch.train._internal import sharded_checkpoint as sc  # noqa: E402
from ray_tpu_torch.train._internal.backend_executor import (  # noqa: E402
    BackendExecutor)
from ray_tpu_torch.train._internal.checkpoint_manager import (  # noqa: E402
    CheckpointManager)
from ray_tpu_torch.train.backend import BackendConfig  # noqa: E402

# Steps from the same state: the two frameworks' summation orders only
# (tests/test_torch_checkpoint.py's and test_torch_train_multiprocess.py's
# bounds).
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-6
B, S = 8, 64
# AdamW moves an element whose gradient is within a few eps of 0 by a
# fraction of the learning rate that the summation order decides: after
# these two steps 2 of wte's 65536 elements lie 4.1e-6 from the JAX step
# (the gap's norm 2.7e-5 of the norm of what the steps changed). So each
# parameter is held to 1e-3 of that norm, tests/test_torch_moe.py's
# ADAMW_UPDATE_RTOL; the optimizer's state and the step to the bounds
# above.
ADAMW_UPDATE_RTOL = 1e-3


@pytest.fixture
def port_cluster():
    ray_tpu_torch.shutdown()
    ctx = ray_tpu_torch.init(num_cpus=8, num_gpus=0, _memory=1e9)
    yield ctx
    ray_tpu_torch.shutdown()


def _counter_total(counter, tag_substr=None):
    if tag_substr is None:
        return sum(counter.series().values())
    return sum(v for k, v in counter.series().items()
               if any(tag_substr in str(part) for part in k))


def _set_flag(name, value):
    from ray_tpu_torch._private.worker import global_worker
    global_worker._runtime.config.set(name, value)


def _state_at(step):
    """Deterministic full training state as a function of the step —
    every rank can recompute it, so restores are checkable exactly."""
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


# ---------------------------------------------------------------------------
# The gang tests of tests/test_sharded_checkpoint.py, on the port's copies
# ---------------------------------------------------------------------------


def _resume_ok(ckpt, rank, world):
    """1.0 when this rank's block of the checkpoint, resharded onto the
    current gang, is the block of the state it was saved from."""
    start = ckpt.to_dict()["step"]
    local, _ = sc.flatten_tree(ckpt.load_for_rank(rank, world))
    flat, _ = sc.flatten_tree(_state_at(start))
    expected = sc.extract_local_shard(flat, sc.default_specs(flat),
                                      [("fsdp", world)], rank)
    return float(all(np.array_equal(arr, np.asarray(local[p]))
                     for p, arr in expected.items()))


def _sharded_loop(total):
    def loop():
        rank = session.get_world_rank()
        world = session.get_world_size()
        ckpt = session.get_checkpoint()
        start = 0
        resume_ok = 1.0
        if ckpt is not None:
            start = ckpt.to_dict()["step"]
            resume_ok = _resume_ok(ckpt, rank, world)
        for i in range(start, total):
            session.report_sharded(
                {"step": i, "world": world, "resume_ok": resume_ok},
                _state_at(i + 1), extra={"step": i + 1})
    return loop


def test_sharded_train_end_to_end(port_cluster, tmp_path):
    """4 ranks each write their own shard file every save; the trainer
    commits the manifest after all acks; metrics/journal record it."""
    persisted_before = _counter_total(
        builtin_metrics.train_checkpoints_persisted())
    saves_hist = builtin_metrics.train_ckpt_save_seconds()
    saves_before = sum(saves_hist._counts.values())
    events.drain_pending()

    trainer = DataParallelTrainer(
        _sharded_loop(3),
        scaling_config=ScalingConfig(num_workers=4),
        run_config=RunConfig(name="shard-e2e",
                             storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.metrics["step"] == 2
    ck = result.checkpoint
    assert isinstance(ck, ShardedCheckpoint)
    assert ck.world_size == 4 and ck.extra == {"step": 3}
    assert _trees_equal(ck.load_full(), _state_at(3))

    names = [n for n in os.listdir(tmp_path) if ".shard-" in n]
    assert {n.rsplit("-", 1)[1] for n in names} >= \
        {"0000", "0001", "0002", "0003"}
    shard_bytes = builtin_metrics.train_ckpt_shard_bytes().series()
    ranks_seen = {part for key in shard_bytes for part in key}
    assert {"0", "1", "2", "3"} <= ranks_seen
    assert _counter_total(
        builtin_metrics.train_checkpoints_persisted()) >= \
        persisted_before + 3
    assert sum(saves_hist._counts.values()) >= saves_before + 3
    msgs = [e["message"] for e in events.drain_pending()]
    assert any("sharded checkpoint" in m and "committed" in m
               for m in msgs), msgs

    second = DataParallelTrainer(
        _sharded_loop(5),
        scaling_config=ScalingConfig(num_workers=4),
        run_config=RunConfig(name="shard-e2e",
                             storage_path=str(tmp_path)))
    r2 = second.fit()
    assert r2.metrics["step"] == 4
    assert r2.metrics["resume_ok"] == 1.0
    assert len(r2.metrics_history) == 2  # started at step 3
    assert r2.checkpoint.extra == {"step": 5}


def test_chaos_shard_write_error_save_aborts_cleanly(port_cluster,
                                                    tmp_path):
    """One rank's shard write raises: that save attempt aborts without
    a manifest, training continues, later saves commit normally."""
    failures_before = _counter_total(
        builtin_metrics.train_checkpoint_persist_failures())
    trainer = DataParallelTrainer(
        _sharded_loop(3),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="shard-io", storage_path=str(tmp_path)))
    chaos.configure(
        "io_oserror:site=train.ckpt_shard_write_error:times=1")
    try:
        result = trainer.fit()
        fired = any(op["fired"] for op in chaos.stats())
    finally:
        chaos.reset()
    assert fired, "chaos io error never fired"
    assert result.metrics["step"] == 2
    assert result.checkpoint.extra == {"step": 3}
    assert _trees_equal(result.checkpoint.load_full(), _state_at(3))
    assert _counter_total(
        builtin_metrics.train_checkpoint_persist_failures()) >= \
        failures_before + 1
    manifests = [n for n in os.listdir(tmp_path) if n.endswith(".manifest")]
    assert not any("000001" in n for n in manifests), manifests


def test_chaos_sigkill_rank_mid_save_acceptance(port_cluster, tmp_path):
    """A rank killed mid-save: the partial save never commits, the gang
    restarts, resume loads the last committed checkpoint, and the next
    index load collects the torn shard set."""
    restarts_before = _counter_total(
        builtin_metrics.train_gang_restarts(), "system")
    trainer = DataParallelTrainer(
        _sharded_loop(4),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="shard-kill", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1)))
    chaos.configure("kill:site=train.ckpt_shard_kill:after=2:times=1")
    try:
        result = trainer.fit()
        fired = any(op["fired"] for op in chaos.stats())
    finally:
        chaos.reset()
    assert fired, "chaos kill never fired"
    assert result.metrics["step"] == 3
    assert result.metrics["resume_ok"] == 1.0
    assert result.checkpoint.extra == {"step": 4}
    assert _trees_equal(result.checkpoint.load_full(), _state_at(4))
    assert _counter_total(builtin_metrics.train_gang_restarts(),
                          "system") >= restarts_before + 1
    events.drain_pending()
    mgr = CheckpointManager(str(tmp_path), "shard-kill")
    latest = mgr.latest()
    assert isinstance(latest, ShardedCheckpoint)
    assert latest.extra == {"step": 4}
    committed = {f for e in mgr._tracked for f in e.get("files", [])} | \
        {os.path.basename(e["uri"].split("://", 1)[1])
         for e in mgr._tracked}
    leftover = [n for n in mgr._backend.list_files("train-shard-kill-ckpt-")
                if ".shard-" in n or n.endswith(".manifest")]
    assert all(n in committed for n in leftover), (leftover, committed)


def test_elastic_shrink_reshard_acceptance(port_cluster, monkeypatch,
                                           tmp_path):
    """A mid-run shrink 8 -> min_workers 4 resumes via reshard with
    identical parameters and finishes the target step count;
    reshards_total{shrink} increments."""
    shrink_before = _counter_total(builtin_metrics.train_reshards(),
                                   "shrink")
    _set_flag("train_restart_wait_s", 0.1)
    monkeypatch.setattr(BackendExecutor, "_placeable_workers",
                        lambda self, desired: 4)

    def loop():
        rank = session.get_world_rank()
        world = session.get_world_size()
        ckpt = session.get_checkpoint()
        start = 0
        resume_ok = 1.0
        if ckpt is not None:
            start = ckpt.to_dict()["step"]
            resume_ok = _resume_ok(ckpt, rank, world)
        for i in range(start, 4):
            session.report_sharded(
                {"step": i, "world": world, "resume_ok": resume_ok},
                _state_at(i + 1), extra={"step": i + 1})
            if world == 8 and i + 1 >= 2:
                raise RuntimeError("slice lost")

    mgr = CheckpointManager(str(tmp_path), "elastic-shrink")
    executor = BackendExecutor(
        BackendConfig(),
        ScalingConfig(num_workers=8, min_workers=4),
        FailureConfig(max_failures=1),
        checkpoint_manager=mgr)
    executor.start()
    try:
        result = executor.run(loop, {}, {"trial_id": "shrink"})
    finally:
        executor.shutdown()
    assert result.metrics["step"] == 3
    assert result.metrics["world"] == 4
    assert result.metrics["resume_ok"] == 1.0
    ck = result.checkpoint
    assert isinstance(ck, ShardedCheckpoint)
    assert ck.world_size == 4 and ck.extra == {"step": 4}
    assert _trees_equal(ck.load_full(), _state_at(4))
    assert _counter_total(builtin_metrics.train_reshards(), "shrink") >= \
        shrink_before + 1


def test_reshard_on_restart_disabled_refuses(port_cluster, tmp_path):
    """With train_reshard_on_restart off, a gang sized differently from
    the saved mesh refuses to resume (a config veto, not a retryable
    TrainingFailedError)."""
    backend = spill.FileSpillBackend(str(tmp_path))
    _, uri, _ = _save_sharded(backend, "frozen", 1, _state_at(1), 2,
                              extra={"step": 1})
    ck = ShardedCheckpoint.from_manifest_uri(uri)
    executor = BackendExecutor(BackendConfig(),
                               ScalingConfig(num_workers=1))
    _set_flag("train_reshard_on_restart", False)
    try:
        with pytest.raises(RuntimeError,
                           match="train_reshard_on_restart"):
            executor._reshard_accounting(ck, new_world=1)
        executor._reshard_accounting(ck, new_world=2)
    finally:
        _set_flag("train_reshard_on_restart", True)


# ---------------------------------------------------------------------------
# The port's train state through report_sharded
# ---------------------------------------------------------------------------


def _batch(seed):
    toks = np.random.default_rng(seed).integers(0, 512, (B, S + 1),
                                                dtype=np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _jax_states(steps):
    """gpt-micro's initial parameters, and the JAX package's whole train
    state after each of ``steps`` steps (batch i at step i), flattened."""
    cfg = jgpt.config("gpt-micro")
    mesh = build_mesh(MeshConfig(dp=1, fsdp=1, tp=1),
                      devices=jax.devices("cpu")[:1])
    opt = jts.default_optimizer(learning_rate=1e-3, warmup_steps=1)
    with jax.default_matmul_precision("highest"):
        state = jts.init_train_state(cfg, mesh, dp_rules(), opt, seed=0)
        params0 = jax.tree_util.tree_map(np.array, state["params"])
        step = jts.make_train_step(cfg, mesh, dp_rules(), opt)
        flats = []
        for i in range(steps):
            state, _ = step(state, {k: jnp.asarray(v)
                                    for k, v in _batch(i).items()})
            flats.append(jsc.flatten_tree(
                jax.tree_util.tree_map(np.array, state))[0])
    return params0, flats


def _own_tree(state):
    """The worker's own state in the JAX package's tree, flattened, as
    copies: the parameters through ``to_jax_params``, the optimizer's
    state through ``to_optax_state``."""
    import torch

    from ray_tpu_torch.models._params import leaf_groups, to_jax_params
    from ray_tpu_torch.parallel import optim

    model = state["params"]
    tree = {"params": to_jax_params(model),
            "opt_state": optim.to_optax_state(state["opt_state"],
                                              leaf_groups(model), "cpu"),
            "step": state["step"]}
    return {p: np.array(v.detach().numpy() if isinstance(v, torch.Tensor)
                        else v, copy=True)
            for p, v in sc.flatten_tree(tree)[0].items()}


def _gpt_loop(config):
    """gpt-micro from the JAX package's parameters: a sharded report at
    each step of ``config["save_at"]``, a plain one at the others; a
    checkpoint from the session resumes through restore_train_state."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.train import restore_train_state

    cfg = gpt.config("gpt-micro")
    opt = ts.default_optimizer(learning_rate=1e-3, warmup_steps=1)
    model = gpt.from_jax_params(config["params"], cfg, "cpu")
    state = {"params": model,
             "opt_state": opt.init(dict(model.named_parameters()),
                                   gpt.leaf_groups(model)),
             "step": torch.zeros((), dtype=torch.int32)}
    loaded = session.get_checkpoint()
    if loaded is not None:
        state = restore_train_state(state, loaded)
    step_fn = ts.make_train_step(cfg, optimizer=opt)
    for i in range(int(state["step"]), config["steps"]):
        batch = {k: torch.from_numpy(v) for k, v in _batch(i).items()}
        state, metrics = step_fn(state, batch)
        report = {"loss": float(metrics["loss"]), "step": i + 1}
        if i + 1 in config["save_at"]:
            report["own"] = _own_tree(state)
            session.report_sharded(report, state, extra={"step": i + 1})
        else:
            session.report(report)


def test_gpt_report_sharded_commits_what_jax_reads_and_resumes(
        port_cluster, tmp_path):
    params0, jax_flats = _jax_states(2)
    config = {"params": params0, "steps": 4, "save_at": (2,)}
    run = RunConfig(name="gpt-sharded", storage_path=str(tmp_path))
    first = TorchTrainer(
        _gpt_loop, train_loop_config=config, run_config=run,
        scaling_config=ScalingConfig(num_workers=1)).fit()
    assert [m["step"] for m in first.metrics_history] == [1, 2, 3, 4]
    ck = first.checkpoint
    assert isinstance(ck, ShardedCheckpoint)
    assert ck.world_size == 1 and ck.extra == {"step": 2}

    # The JAX package reads the committed manifest and its one shard.
    jck = jsc.ShardedCheckpoint.from_manifest_uri(ck.uri)
    got, _ = jsc.flatten_tree(jck.load_full())
    want, before = jax_flats[1], jsc.flatten_tree({"params": params0})[0]
    assert set(got) == set(want)
    for p, w in want.items():
        assert got[p].dtype == w.dtype, p
        if p in before:
            change = np.linalg.norm(w - before[p])
            gap = np.linalg.norm(got[p] - w)
            assert gap <= ADAMW_UPDATE_RTOL * change, (p, gap, change)
        else:
            np.testing.assert_allclose(got[p], w, atol=PARAM_ATOL,
                                       rtol=STEP_RTOL, err_msg=p)
    assert int(got["step"]) == 2
    # What was committed is the worker's own state at step 2, bit for bit.
    own = first.metrics_history[1]["own"]
    assert set(own) == set(got)
    for p, v in own.items():
        assert got[p].dtype == v.dtype, p
        np.testing.assert_array_equal(got[p], v, err_msg=p)

    # A run under the same name resumes from the commit: steps 3 and 4
    # again, bit-equal.
    second = TorchTrainer(
        _gpt_loop, train_loop_config=config, run_config=run,
        scaling_config=ScalingConfig(num_workers=1)).fit()
    assert [m["step"] for m in second.metrics_history] == [3, 4]
    assert [m["loss"] for m in second.metrics_history] == \
        [m["loss"] for m in first.metrics_history[2:]]


def test_a_placed_state_is_reported_inside_its_registered_mesh(
        port_cluster, tmp_path, monkeypatch):
    """report_sharded reads the mesh and rules from
    parallel.mesh.registered_mesh: a state on a mesh reported outside
    one raises, as does a specs argument for a train state."""
    # The loop's 1-rank group is this process's own, whatever rendezvous
    # variables an earlier test left here.
    for name in ("MASTER_ADDR", "MASTER_PORT", "RAY_TPU_WORLD_SIZE",
                 "RAY_TPU_RANK"):
        monkeypatch.delenv(name, raising=False)
    def loop():
        import torch.distributed as dist

        from ray_tpu_torch.models import gpt
        from ray_tpu_torch.parallel import MeshConfig as TorchMeshConfig
        from ray_tpu_torch.parallel import train_step as ts
        from ray_tpu_torch.parallel.mesh import registered_mesh
        from ray_tpu_torch.train import prepare_mesh

        mesh = prepare_mesh(TorchMeshConfig(dp=1, fsdp=1, tp=1),
                            device="cpu")
        errors = []
        try:
            state = ts.init_train_state(gpt.config("gpt-micro"), mesh,
                                        device="cpu")
            try:
                session.report_sharded({}, state)
            except ValueError as exc:
                errors.append(str(exc))
            with registered_mesh(mesh):
                try:
                    session.report_sharded({}, state, specs={})
                except ValueError as exc:
                    errors.append(str(exc))
        finally:
            dist.destroy_process_group()
        session.report({"errors": errors})

    result = TorchTrainer(
        loop, run_config=RunConfig(name="outside",
                                   storage_path=str(tmp_path)),
        scaling_config=ScalingConfig(num_workers=1)).fit()
    errors = result.metrics["errors"]
    assert len(errors) == 2
    assert "registered_mesh" in errors[0]
    assert "pass neither" in errors[1]


# -- two gloo worker processes under fsdp_rules ------------------------------


def _fsdp_loop(config):
    """gpt-micro on MeshConfig(fsdp=world) under fsdp_rules: a sharded
    report after every step, the last of whose writes fails on rank 1 by
    an injected io_oserror; the whole parameters at each step."""
    import torch

    from ray_tpu_torch._private import chaos as port_chaos
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import MeshConfig as TorchMeshConfig
    from ray_tpu_torch.parallel import fsdp_rules as torch_fsdp_rules
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.mesh import registered_mesh
    from ray_tpu_torch.train import prepare_mesh

    torch.set_num_threads(1)
    rank, world = session.get_world_rank(), session.get_world_size()
    mesh = prepare_mesh(TorchMeshConfig(fsdp=world), device="cpu")
    cfg = gpt.config("gpt-micro")
    rules = torch_fsdp_rules()
    opt = ts.default_optimizer(learning_rate=1e-3, warmup_steps=1)
    model = sharding.shard_model(
        gpt.from_jax_params(config["params"], cfg, "cpu"), mesh,
        gpt.param_specs(cfg, rules))
    state = {"params": model,
             "opt_state": opt.init(dict(model.named_parameters()),
                                   gpt.leaf_groups(model)),
             "step": torch.zeros((), dtype=torch.int32)}
    step = ts.make_train_step(cfg, mesh, rules, opt)
    for i in range(config["steps"]):
        batch = {k: torch.from_numpy(v) for k, v in _batch(i).items()}
        state, m = step(state, batch)
        with torch.no_grad():
            whole = {n: (p.full_tensor() if hasattr(p, "full_tensor")
                         else p).numpy()
                     for n, p in model.named_parameters()}
        if rank == 1 and i + 1 == config["steps"]:
            port_chaos.configure(
                "io_oserror:site=train.ckpt_shard_write_error:times=1")
        with registered_mesh(mesh, rules):
            session.report_sharded({"loss": float(m["loss"]), "step": i + 1,
                                    "params": whole},
                                   state, extra={"step": i + 1})


def test_two_worker_processes_write_their_own_blocks(port_cluster,
                                                     tmp_path):
    params0, _ = _jax_states(0)
    result = TorchTrainer(
        _fsdp_loop, train_loop_config={"params": params0, "steps": 2},
        run_config=RunConfig(name="fsdp2", storage_path=str(tmp_path)),
        scaling_config=ScalingConfig(
            num_workers=2, resources_per_worker={"CPU": 1},
            runtime_env={"worker_process": True})).fit()
    assert [m["step"] for m in result.metrics_history] == [1, 2]
    # Rank 1's write of the last save failed: that save committed
    # nothing, and the save before it is still the latest.
    ck = result.checkpoint
    assert isinstance(ck, ShardedCheckpoint) and ck.extra == {"step": 1}
    latest = CheckpointManager(str(tmp_path), "fsdp2").latest()
    assert latest.uri == ck.uri
    manifests = [n for n in os.listdir(tmp_path) if n.endswith(".manifest")]
    assert len(manifests) == 1, manifests

    manifest = ck.manifest
    assert manifest["world_size"] == 2
    assert [s["rank"] for s in manifest["shards"]] == [0, 1]
    assert len({s["file"] for s in manifest["shards"]}) == 2
    axes = [tuple(a) for a in manifest["mesh"]]
    assert dict(axes)["fsdp"] == 2
    # Each shard holds its rank's block of every leaf, and the blocks of
    # a leaf split over fsdp are halves, not the whole.
    halves = 0
    for shard in manifest["shards"]:
        coords = sc.rank_coords(shard["rank"], axes)
        for path, block in shard["blocks"].items():
            whole = manifest["params"][path]["shape"]
            want = tuple(s.stop - s.start for s in sc.shard_slices(
                tuple(whole), manifest["specs"][path], dict(axes), coords))
            # write_shard records a 0-d leaf's block as (1,), in both
            # packages.
            assert tuple(block["shape"]) == (want or (1,)), path
            halves += tuple(block["shape"]) != tuple(whole)
    assert halves > 0
    # The JAX package reads the whole parameters the ranks held at step 1.
    tree = jsc.ShardedCheckpoint.from_manifest_uri(ck.uri).load_full()
    saved = result.metrics_history[0]["params"]
    for name, value in saved.items():
        parts = name.split(".")
        got = (tree["params"]["layers"][parts[2]][int(parts[1])]
               if parts[0] == "blocks" else tree["params"][name])
        np.testing.assert_array_equal(got, value, err_msg=name)

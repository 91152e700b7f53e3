"""TorchTrainer and the gang under it, on the port's own runtime.

Mirrors the framework tests of tests/test_train.py (a loop on one and on
four ranks, checkpoints and resume, failure, gang restart, dataset
shards), the runtime tests of tests/test_train_fault_tolerance.py (chaos
kill and gang restart from a durable checkpoint, the hang probe,
max_failures 0 and -1, auto-resume, elastic shrink) and its north star,
test_jax_trainer_gpt_e2e: gpt-tiny from the JAX package's parameters
trained through TorchTrainer, each step's loss held to the JAX package's
train step on the same batch, then resumed from its checkpoint. Each test
runs against ``ray_tpu_torch.init``/``shutdown`` in this file's fixture.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import builtin_metrics, chaos
from ray_tpu_torch.air import (Checkpoint, FailureConfig, RunConfig,
                               ScalingConfig, session)
from ray_tpu_torch.exceptions import PlacementGroupError, is_system_failure
from ray_tpu_torch.train import (DataParallelTrainer, TorchBackendConfig,
                                 TorchTrainer)
from ray_tpu_torch.train._internal.backend_executor import (
    BackendExecutor, TrainingFailedError)
from ray_tpu_torch.train.backend import BackendConfig

# 3 fp32 steps of gpt-tiny against the JAX package's train step:
# tests/test_torch_train_step.py's bound (summation order only).
STEP_RTOL = 1e-5


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


def _step_loop(total):
    def loop():
        ckpt = session.get_checkpoint()
        start = ckpt.to_dict()["step"] if ckpt else 0
        for i in range(start, total):
            session.report({"step": i},
                           checkpoint=Checkpoint.from_dict({"step": i + 1}))
    return loop


# ---------------------------------------------------------------------------
# The framework (tests/test_train.py)
# ---------------------------------------------------------------------------


def test_single_worker_loop(port_cluster):
    def loop(config):
        for i in range(3):
            session.report({"iter": i, "x": config["x"]})

    result = DataParallelTrainer(
        loop, train_loop_config={"x": 42},
        scaling_config=ScalingConfig(num_workers=1)).fit()
    assert len(result.metrics_history) == 3
    assert result.metrics == {"iter": 2, "x": 42}


def test_multi_worker_ranks(port_cluster):
    def loop():
        session.report({"rank": session.get_world_rank(),
                        "world": session.get_world_size()})

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=4)).fit()
    assert result.metrics["rank"] == 0
    assert result.metrics["world"] == 4


def test_checkpoint_flow(port_cluster):
    def loop():
        ckpt = session.get_checkpoint()
        start = ckpt.to_dict()["step"] if ckpt else 0
        for i in range(start, 4):
            session.report({"step": i},
                           checkpoint=Checkpoint.from_dict({"step": i + 1}))

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1)).fit()
    assert result.checkpoint.to_dict() == {"step": 4}
    result2 = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        resume_from_checkpoint=Checkpoint.from_dict({"step": 3})).fit()
    assert len(result2.metrics_history) == 1  # only step 3 ran


def test_failure_propagates(port_cluster):
    def loop():
        session.report({"ok": 1})
        raise RuntimeError("worker exploded")

    with pytest.raises(TrainingFailedError):
        DataParallelTrainer(
            loop, scaling_config=ScalingConfig(num_workers=2)).fit()


def test_gang_restart_from_checkpoint(port_cluster):
    def loop():
        ckpt = session.get_checkpoint()
        start = ckpt.to_dict()["step"] if ckpt else 0
        for i in range(start, 6):
            if i == 3 and ckpt is None:
                raise RuntimeError("simulated slice failure")
            session.report({"step": i},
                           checkpoint=Checkpoint.from_dict({"step": i + 1}))

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(failure_config=FailureConfig(
            max_failures=1))).fit()
    assert result.metrics["step"] == 5
    assert result.checkpoint.to_dict() == {"step": 6}


def test_dataset_shards(port_cluster):
    class FakeDataset:
        def __init__(self, items):
            self.items = items

        def split(self, n, equal=True):
            per = len(self.items) // n
            return [FakeDataset(self.items[i * per:(i + 1) * per])
                    for i in range(n)]

    def loop():
        shard = session.get_dataset_shard("train")
        session.report({"n": len(shard.items), "first": shard.items[0]})

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2),
        datasets={"train": FakeDataset(list(range(10)))}).fit()
    assert result.metrics["n"] == 5


# ---------------------------------------------------------------------------
# The card: reserved as "GPU", and no silent CPU fallback
# ---------------------------------------------------------------------------


def test_use_gpu_reserves_a_card_per_worker():
    assert ScalingConfig(num_workers=2, use_gpu=True).worker_resources() \
        == {"CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig(use_gpu=True, gpus_per_worker=0.5,
                         resources_per_worker={"CPU": 2}
                         ).worker_resources() == {"CPU": 2, "GPU": 0.5}
    assert ScalingConfig().worker_resources() == {"CPU": 1.0}


def test_torch_trainer_defaults_to_the_card_and_raises_without_one(
        port_cluster):
    """TorchTrainer reserves a card unless the caller asks for the CPU;
    on a host without one the gang cannot be placed."""
    trainer = TorchTrainer(lambda: session.report({"ok": 1}))
    assert trainer.scaling_config.use_gpu
    assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0
    with pytest.raises(PlacementGroupError, match="GPU"):
        trainer.fit()


def test_worker_process_without_a_card_lease_sees_none(port_cluster):
    """A worker process whose lease holds no GPU sees no card, and the
    port's entry points raise there rather than fall back to the CPU."""
    @ray_tpu_torch.remote(runtime_env={"worker_process": True})
    def probe():
        import os

        import torch

        from ray_tpu_torch import resolve_device
        try:
            resolve_device(None)
            raised = None
        except RuntimeError as exc:
            raised = str(exc)
        return (os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.device_count(), ray_tpu_torch.get_gpu_ids(),
                raised)

    pid, visible, count, ids, raised = ray_tpu_torch.get(probe.remote())
    assert pid != os.getpid()
    assert visible == "" and count == 0 and ids == []
    assert raised is not None and "CUDA is not available" in raised


@pytest.mark.parametrize("worker_process", [True, False],
                         ids=["worker_process", "thread"])
def test_actors_hold_disjoint_cards_of_their_leases(worker_process):
    """On a node of two (declared) cards, two one-card actors hold one id
    each; in a worker process CUDA_VISIBLE_DEVICES is that id."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=2, _memory=1e9)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] == 2

        @ray_tpu_torch.remote(num_gpus=1, runtime_env={
            "worker_process": worker_process})
        class Probe:
            def where(self):
                import os
                return (os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES"),
                        ray_tpu_torch.get_gpu_ids())

        probes = [Probe.remote(), Probe.remote()]
        got = ray_tpu_torch.get([p.where.remote() for p in probes])
        assert sorted(ids for _, _, ids in got) == [[0], [1]]
        for pid, visible, ids in got:
            assert (pid != os.getpid()) == worker_process
            if worker_process:
                assert visible == str(ids[0])
    finally:
        ray_tpu_torch.shutdown()


def _where_fn():
    def where():
        """This process, the cards it may see, and its lease's ids."""
        import os

        import ray_tpu_torch
        return (os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES"),
                ray_tpu_torch.get_gpu_ids())
    return where


# A nested function: cloudpickle ships it by value to worker processes,
# which cannot import this test module.
_where = _where_fn()


def test_a_pooled_worker_serves_one_card_set():
    """CUDA reads CUDA_VISIBLE_DEVICES once per process: a task without a
    GPU never reuses a worker that held a card, nor a GPU task one that
    held none, while each kind reuses its own."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1, _memory=1e9)
    try:
        cpu = ray_tpu_torch.remote(runtime_env={"worker_process": True})(
            _where)
        gpu = ray_tpu_torch.remote(num_gpus=1, runtime_env={
            "worker_process": True})(_where)
        got = [ray_tpu_torch.get(f.remote()) for f in (cpu, gpu, cpu, gpu)]
        (c1, cv1, cids1), (g1, gv1, gids1), (c2, cv2, _), (g2, gv2, _) = got
        assert (cv1, cv2, cids1) == ("", "", [])
        assert (gv1, gv2, gids1) == ("0", "0", [0])
        assert c1 == c2 and g1 == g2 and c1 != g1
    finally:
        ray_tpu_torch.shutdown()


def test_fractional_leases_share_one_card():
    """Two half-card actors pack onto one card and hold its id (a worker
    process sees it); a whole-card actor takes the other card, and gets
    the shared one back once both halves are gone."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=2, _memory=1e9)
    try:
        @ray_tpu_torch.remote(runtime_env={"worker_process": True})
        class Probe:
            def where(self):
                return _where()

        halves = [Probe.options(num_gpus=0.5).remote() for _ in range(2)]
        (_, v1, ids1), (_, v2, ids2) = ray_tpu_torch.get(
            [h.where.remote() for h in halves])
        assert ids1 == ids2 and len(ids1) == 1
        assert v1 == v2 == str(ids1[0])
        whole = Probe.options(num_gpus=1).remote()
        assert ray_tpu_torch.get(whole.where.remote())[2] == [1 - ids1[0]]
        for h in halves:
            ray_tpu_torch.kill(h)
        deadline = time.monotonic() + 20
        while ray_tpu_torch.available_resources().get("GPU", 0) < 1:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        again = Probe.options(num_gpus=1).remote()
        assert ray_tpu_torch.get(again.where.remote())[2] == ids1
    finally:
        ray_tpu_torch.shutdown()


def test_gpus_per_worker_fraction_holds_its_card():
    """ScalingConfig(gpus_per_worker=0.5): two worker-process ranks share
    the one card and each sees it, and get_metadata reports its id, so
    torch_distributed_init would take NCCL there, not gloo."""
    from ray_tpu_torch.train.backend import Backend

    metas = []

    class Recording(BackendConfig):
        @property
        def backend_cls(self):
            class _Backend(Backend):
                def on_start(self, worker_group, backend_config):
                    metas.extend(worker_group.execute("get_metadata"))
            return _Backend

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1, _memory=1e9)
    try:
        def loop():
            pid, visible, _ = _where()
            session.report({"pid": pid, "visible": visible})

        result = DataParallelTrainer(
            loop, backend_config=Recording(),
            scaling_config=ScalingConfig(
                num_workers=2, use_gpu=True, gpus_per_worker=0.5,
                runtime_env={"worker_process": True})).fit()
        assert result.metrics["visible"] == "0"
        assert [m["gpu_ids"] for m in metas] == [[0], [0]]
        assert len({m["pid"] for m in metas} | {os.getpid()}) == 3
    finally:
        ray_tpu_torch.shutdown()


def test_a_remote_node_runs_gpu_tasks_in_workers_of_their_lease(tmp_path):
    """A node daemon runs a GPU task in a worker process that sees only
    its lease's card, and a CPU task in another that sees none."""
    import json
    import subprocess
    import sys

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, _memory=1e9)
    _, port = ray_tpu_torch.start_head_server(port=0, host="127.0.0.1")
    daemon = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.multinode",
         "--address", f"127.0.0.1:{port}", "--num-cpus", "2",
         "--num-tpus", "1", "--resources", json.dumps({"nd": 100}),
         "--spill-dir", str(tmp_path)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 30
        while ray_tpu_torch.cluster_resources().get("nd", 0) < 100:
            assert time.monotonic() < deadline, "the daemon never joined"
            time.sleep(0.1)
        assert ray_tpu_torch.cluster_resources()["GPU"] == 1
        gpu = ray_tpu_torch.remote(num_gpus=1, resources={"nd": 1})(_where)
        cpu = ray_tpu_torch.remote(resources={"nd": 1})(_where)
        (gpid, gvis, gids), (cpid, cvis, cids) = ray_tpu_torch.get(
            [gpu.remote(), cpu.remote()], timeout=60)
        assert (gvis, gids) == ("0", [0]) and (cvis, cids) == ("", [])
        assert len({gpid, cpid, daemon.pid, os.getpid()}) == 4
    finally:
        ray_tpu_torch.shutdown()
        if daemon.poll() is None:
            daemon.kill()
        daemon.wait(timeout=10)


# ---------------------------------------------------------------------------
# Fault tolerance (tests/test_train_fault_tolerance.py)
# ---------------------------------------------------------------------------


def test_chaos_worker_kill_gang_restart_durable(port_cluster, tmp_path):
    restarts_before = _counter_total(
        builtin_metrics.train_gang_restarts(), "system")
    persisted_before = _counter_total(
        builtin_metrics.train_checkpoints_persisted())
    trainer = DataParallelTrainer(
        _step_loop(8), scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="chaos-kill", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)))
    chaos.configure("kill:site=train.worker_kill:after=6:times=1")
    try:
        result = trainer.fit()
        killed = any(op["fired"] for op in chaos.stats())
    finally:
        chaos.reset()
    assert killed, "chaos kill never fired"
    assert result.metrics["step"] == 7
    assert result.checkpoint.to_dict() == {"step": 8}
    assert _counter_total(builtin_metrics.train_gang_restarts(),
                          "system") >= restarts_before + 1
    assert _counter_total(
        builtin_metrics.train_checkpoints_persisted()) > persisted_before
    assert any(f.endswith(".ckpt") for f in os.listdir(tmp_path))


def test_hang_timeout_liveness_probe(port_cluster):
    _set_flag("train_hang_timeout_s", 0.5)
    restarts_before = _counter_total(
        builtin_metrics.train_gang_restarts(), "system")
    trainer = DataParallelTrainer(
        _step_loop(4), scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=0)))
    chaos.configure("delay_ms:site=train.result:ms=8000:times=1;"
                    "delay_ms:site=train.ping:ms=8000:times=2")
    t0 = time.monotonic()
    try:
        with pytest.raises(TrainingFailedError) as excinfo:
            trainer.fit()
    finally:
        chaos.reset()
    assert excinfo.value.cause_kind == "system"
    assert "liveness" in str(excinfo.value)
    assert time.monotonic() - t0 < 6.0
    assert _counter_total(builtin_metrics.train_gang_restarts(),
                          "system") == restarts_before


def test_system_failure_max_failures_zero_fails_fast(port_cluster):
    trainer = DataParallelTrainer(
        _step_loop(4), scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=0)))
    chaos.configure("kill:site=train.worker_kill:after=2:times=1")
    try:
        with pytest.raises(TrainingFailedError) as excinfo:
            trainer.fit()
    finally:
        chaos.reset()
    assert excinfo.value.cause_kind == "system"
    assert is_system_failure(excinfo.value.__cause__)


def test_max_failures_zero_fails_fast_with_cause(port_cluster):
    def loop():
        session.report({"ok": 1})
        raise ValueError("boom at step 1")

    with pytest.raises(TrainingFailedError) as excinfo:
        DataParallelTrainer(
            loop, scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(failure_config=FailureConfig(
                max_failures=0))).fit()
    assert excinfo.value.cause_kind == "app"
    assert "boom at step 1" in str(excinfo.value)
    assert isinstance(excinfo.value.__cause__, ValueError)


def test_max_failures_infinite_retries(port_cluster, tmp_path):
    marker = tmp_path / "attempts"

    def loop(config):
        with open(config["marker"], "a") as f:
            f.write("x")
        attempt = os.path.getsize(config["marker"])
        ckpt = session.get_checkpoint()
        start = ckpt.to_dict()["step"] if ckpt else 0
        for i in range(start, 5):
            session.report({"step": i, "attempt": attempt},
                           checkpoint=Checkpoint.from_dict({"step": i + 1}))
            if attempt <= 3 and i == attempt - 1:
                raise RuntimeError(f"attempt {attempt} dies after step {i}")

    result = DataParallelTrainer(
        loop, train_loop_config={"marker": str(marker)},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="forever",
                             storage_path=str(tmp_path / "store"),
                             failure_config=FailureConfig(
                                 max_failures=-1))).fit()
    assert result.metrics["step"] == 4
    assert result.metrics["attempt"] == 4
    assert result.checkpoint.to_dict() == {"step": 5}


def test_auto_resume_same_run_name(port_cluster, tmp_path):
    run = RunConfig(name="resumable", storage_path=str(tmp_path))
    r1 = DataParallelTrainer(
        _step_loop(3), scaling_config=ScalingConfig(num_workers=1),
        run_config=run).fit()
    assert r1.metrics["step"] == 2
    r2 = DataParallelTrainer(
        _step_loop(5), scaling_config=ScalingConfig(num_workers=1),
        run_config=run).fit()
    assert r2.metrics["step"] == 4
    assert len(r2.metrics_history) == 2
    assert r2.checkpoint.to_dict() == {"step": 5}


@pytest.mark.parametrize("placeable,max_failures", [(2, 1), (1, 5)],
                         ids=["shrinks_to_min_workers",
                              "below_min_workers_fails"])
def test_elastic_restart(port_cluster, monkeypatch, placeable, max_failures):
    def loop():
        if session.get_world_size() == 4 or placeable < 2:
            raise RuntimeError("slice lost")
        session.report({"world": session.get_world_size()})

    _set_flag("train_restart_wait_s", 0.1)
    monkeypatch.setattr(BackendExecutor, "_placeable_workers",
                        lambda self, desired: placeable)
    executor = BackendExecutor(
        BackendConfig(), ScalingConfig(num_workers=4, min_workers=2),
        FailureConfig(max_failures=max_failures))
    executor.start()
    try:
        if placeable >= 2:
            result = executor.run(loop, {}, {"trial_id": "elastic"})
            assert result.metrics["world"] == 2
        else:
            with pytest.raises(TrainingFailedError) as excinfo:
                executor.run(loop, {}, {"trial_id": "too-small"})
            assert excinfo.value.cause_kind == "system"
            assert "min_workers=2" in str(excinfo.value)
    finally:
        executor.shutdown()


# ---------------------------------------------------------------------------
# The north star (test_jax_trainer_gpt_e2e): gpt-tiny through TorchTrainer
# ---------------------------------------------------------------------------


def _gpt_batch():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 256, (8, 32), dtype=np.int32),
            "targets": rng.integers(0, 256, (8, 32), dtype=np.int32)}


def _jax_reference(steps):
    """gpt-tiny's initial parameters from ray_tpu.models.gpt.init, and the
    JAX package's train step's losses on the e2e test's batch."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import MeshConfig, build_mesh, dp_rules
    from ray_tpu.parallel import train_step as jts

    cfg = jgpt.config("gpt-tiny")
    mesh = build_mesh(MeshConfig(dp=1, fsdp=1, tp=1),
                      devices=jax.devices("cpu")[:1])
    opt = jts.default_optimizer(learning_rate=1e-3, warmup_steps=1)
    batch = {k: jnp.asarray(v) for k, v in _gpt_batch().items()}
    with jax.default_matmul_precision("highest"):
        state = jts.init_train_state(cfg, mesh, dp_rules(), opt, seed=0)
        params0 = jax.tree_util.tree_map(np.asarray, state["params"])
        step = jts.make_train_step(cfg, mesh, dp_rules(), opt)
        losses = []
        for _ in range(steps):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
    return params0, losses


def _gpt_loop(config):
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.train import (CheckpointManager, restore_train_state,
                                     save_train_state)

    cfg = gpt.config("gpt-tiny")
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
    batch = {k: torch.from_numpy(v) for k, v in config["batch"].items()}
    for i in range(int(state["step"]), config["steps"]):
        state, metrics = step_fn(state, batch)
        ckpt = None
        if i + 1 == config["save_at"]:
            ckpt = save_train_state(
                state, CheckpointManager(config["dir"], "gpt-e2e"),
                extra={"step": i + 1})
        session.report({"loss": float(metrics["loss"]), "step": i + 1},
                       checkpoint=ckpt)


def test_torch_trainer_gpt_e2e(port_cluster, tmp_path):
    params0, ref_losses = _jax_reference(5)
    config = {"params": params0, "batch": _gpt_batch(), "steps": 3,
              "save_at": 3, "dir": str(tmp_path)}
    result = TorchTrainer(
        _gpt_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=1)).fit()
    assert [m["step"] for m in result.metrics_history] == [1, 2, 3]
    assert result.checkpoint.extra_metadata["step"] == 3
    losses = [m["loss"] for m in result.metrics_history]

    resumed = TorchTrainer(
        _gpt_loop, train_loop_config={**config, "steps": 5},
        scaling_config=ScalingConfig(num_workers=1),
        resume_from_checkpoint=result.checkpoint).fit()
    assert [m["step"] for m in resumed.metrics_history] == [4, 5]
    losses += [m["loss"] for m in resumed.metrics_history]
    np.testing.assert_allclose(losses, ref_losses, rtol=STEP_RTOL)


def test_an_in_process_gang_gets_no_process_group(port_cluster,
                                                  monkeypatch):
    """As in ray_tpu/train/jax: the backend starts no group for ranks on
    threads of this process, and sets none of the rendezvous variables."""
    # A JaxTrainer run earlier in this process leaves its ranks' variables
    # in os.environ; the check is of what this backend sets.
    for key in ("MASTER_ADDR", "MASTER_PORT", "RAY_TPU_WORLD_SIZE",
                "RAY_TPU_RANK"):
        monkeypatch.delenv(key, raising=False)
    def loop():
        import os

        import torch.distributed as dist
        session.report({"group": dist.is_initialized(),
                        "env": [k for k in ("MASTER_ADDR", "MASTER_PORT",
                                            "RAY_TPU_WORLD_SIZE",
                                            "RAY_TPU_RANK")
                                if k in os.environ],
                        "pid": os.getpid()})

    result = TorchTrainer(
        loop, backend_config=TorchBackendConfig(),
        scaling_config=ScalingConfig(num_workers=2)).fit()
    assert result.metrics == {"group": False, "env": [], "pid": os.getpid()}


class _FakeGang:
    """The two calls of _TorchBackend.on_start that precede a group:
    get_metadata on every rank, then setup_env on each worker."""

    def __init__(self, procs):
        self.metas = [{"rank": r, "hostname": h, "pid": p, "gpu_ids": []}
                      for r, (h, p) in enumerate(procs)]
        self.workers = [object() for _ in procs]
        self.calls = []

    def execute(self, method):
        self.calls.append(method)
        return self.metas if method == "get_metadata" else None


def test_the_backend_starts_a_group_only_for_ranks_of_their_own():
    """No group for ranks on threads of this process; ranks that share
    another process (a remote daemon's threads) raise, since a process
    holds one group and one set of rendezvous variables."""
    import socket

    from ray_tpu_torch.train.torch import _TorchBackend
    here = (socket.gethostname(), os.getpid())
    gang = _FakeGang([here, here])
    _TorchBackend().on_start(gang, TorchBackendConfig())
    assert gang.calls == ["get_metadata"]
    for procs in ([("node-b", 7), ("node-b", 7)],
                  [here, ("node-b", 7), ("node-b", 7)]):
        with pytest.raises(RuntimeError, match="a process of its own"):
            _TorchBackend().on_start(_FakeGang(procs), TorchBackendConfig())

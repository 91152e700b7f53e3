"""Tune on the port's runtime (``ray_tpu_torch.tune``, a copy of the JAX
package's with one hunk in ``with_resources`` and one in the exploit's
kill: ``tests/_torch_runtime_copy.py``).

``tests/test_tune.py``'s 24 cases by name, its trainer case over
``TorchTrainer``; then Tune over ``TorchTrainer`` training gpt-tiny
against the same ``Tuner`` over ``JaxTrainer`` (each trial's reported
losses, to ``tests/test_torch_train.py``'s bound); ``with_resources``'
GPU hunk; and the stop and kill paths with worker-process gangs: after a
trial stopped by ``stop={"training_iteration": 1}`` and after a PBT
exploit, no gang process remains and every lease is back.
"""


import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.air import RunConfig, ScalingConfig, session
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.train import DataParallelTrainer, TorchTrainer
from ray_tpu_torch.tune import ASHAScheduler, TuneConfig, Tuner
from test_torch_train import STEP_RTOL


@pytest.fixture
def port_cluster():
    ray_tpu_torch.shutdown()
    ctx = ray_tpu_torch.init(num_cpus=8, num_gpus=0, _memory=1e9)
    yield ctx
    ray_tpu_torch.shutdown()


@pytest.fixture
def one_card():
    """A cluster that declares one card (the CPU stands in for it: nothing
    here launches CUDA work)."""
    ray_tpu_torch.shutdown()
    ctx = ray_tpu_torch.init(num_cpus=8, num_gpus=1, _memory=1e9)
    yield ctx
    ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# tests/test_tune.py's cases on the port's runtime
# ---------------------------------------------------------------------------



def test_grid_search(port_cluster):
    def trainable(config):
        tune.report({"score": config["a"] * 10 + config["b"]})

    tuner = Tuner(
        trainable,
        param_space={"a": tune.grid_search([1, 2, 3]),
                     "b": tune.grid_search([0, 1])},
        tune_config=TuneConfig(metric="score", mode="max"),
    )
    results = tuner.fit()
    assert len(results) == 6
    best = results.get_best_result()
    assert best.metrics["score"] == 31
    assert best.config == {"a": 3, "b": 1}


def test_random_sampling(port_cluster):
    def trainable(config):
        tune.report({"value": config["lr"]})

    tuner = Tuner(
        trainable,
        param_space={"lr": tune.loguniform(1e-5, 1e-1)},
        tune_config=TuneConfig(metric="value", mode="min", num_samples=8),
    )
    results = tuner.fit()
    assert len(results) == 8
    values = [r.metrics["value"] for r in results]
    assert all(1e-5 <= v <= 1e-1 for v in values)
    assert len(set(values)) > 1  # actually sampled


def test_num_samples_multiplies_grid(port_cluster):
    def trainable(config):
        tune.report({"x": config["g"]})

    tuner = Tuner(
        trainable,
        param_space={"g": tune.grid_search([1, 2])},
        tune_config=TuneConfig(num_samples=3, metric="x", mode="max"),
    )
    assert len(tuner.fit()) == 6


def test_trial_errors_recorded(port_cluster):
    def trainable(config):
        if config["i"] == 1:
            raise ValueError("bad trial")
        tune.report({"ok": 1})

    tuner = Tuner(
        trainable,
        param_space={"i": tune.grid_search([0, 1, 2])},
        tune_config=TuneConfig(metric="ok", mode="max"),
    )
    results = tuner.fit()
    assert len(results.errors) == 1
    assert results.get_best_result().metrics["ok"] == 1


def test_asha_stops_bad_trials(port_cluster):
    def trainable(config):
        for i in range(20):
            tune.report({"score": config["quality"] * (i + 1)})

    tuner = Tuner(
        trainable,
        param_space={"quality": tune.grid_search([1, 2, 3, 4, 5, 6, 7, 8])},
        tune_config=TuneConfig(
            metric="score", mode="max",
            scheduler=ASHAScheduler(max_t=20, grace_period=2,
                                    reduction_factor=4)),
    )
    results = tuner.fit()
    best = results.get_best_result()
    assert best.config["quality"] == 8
    # Early stopping must have cut at least one weak trial short.
    lengths = [len(r.metrics_history) for r in results]
    assert min(lengths) < 20


def test_stop_criteria(port_cluster):
    def trainable(config):
        for i in range(100):
            tune.report({"iters": i})

    tuner = Tuner(
        trainable,
        tune_config=TuneConfig(metric="iters", mode="max"),
        run_config=RunConfig(stop={"iters": 5}),
    )
    results = tuner.fit()
    assert len(results[0].metrics_history) <= 8


def test_tuner_over_trainer(port_cluster):
    from ray_tpu_torch.air import session
    from ray_tpu_torch.train import DataParallelTrainer

    def loop(config):
        session.report({"final": config["x"] * 2})

    trainer = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1))
    tuner = Tuner(
        trainer,
        param_space={"x": tune.grid_search([1, 5])},
        tune_config=TuneConfig(metric="final", mode="max"),
    )
    results = tuner.fit()
    assert len(results) == 2
    assert results.get_best_result().metrics["final"] == 10


def test_tuner_over_torch_trainer(port_cluster):
    """tests/test_tune.py's test_tuner_over_jax_trainer over TorchTrainer:
    the trainer-clone path must work for TorchTrainer too (its __init__
    signature differs from DataParallelTrainer's)."""
    from ray_tpu_torch.air import session
    from ray_tpu_torch.train import TorchTrainer

    def loop(config):
        session.report({"final": config["x"] * 3})

    trainer = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=1))
    results = Tuner(
        trainer,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=TuneConfig(metric="final", mode="max"),
    ).fit()
    assert not results.errors
    assert results.get_best_result().metrics["final"] == 6


def test_with_parameters_and_resources(port_cluster):
    big_object = list(range(1000))

    def trainable(config, data=None):
        tune.report({"n": len(data) + config["k"]})

    wrapped = tune.with_parameters(trainable, data=big_object)
    wrapped = tune.with_resources(wrapped, {"cpu": 2})
    tuner = Tuner(wrapped, param_space={"k": tune.grid_search([0, 1])},
                  tune_config=TuneConfig(metric="n", mode="max"))
    results = tuner.fit()
    assert results.get_best_result().metrics["n"] == 1001


def test_hyperband_stops_bad_trials(port_cluster):
    from ray_tpu_torch.tune import HyperBandScheduler

    def trainable(config):
        for i in range(30):
            tune.report({"score": config["q"] * (i + 1)})

    results = Tuner(
        trainable,
        param_space={"q": tune.grid_search(list(range(1, 10)))},
        tune_config=TuneConfig(
            metric="score", mode="max",
            scheduler=HyperBandScheduler(max_t=27, reduction_factor=3)),
    ).fit()
    assert results.get_best_result().config["q"] == 9
    lengths = [len(r.metrics_history) for r in results]
    assert min(lengths) < 27


def test_median_stopping_rule(port_cluster):
    from ray_tpu_torch.tune import MedianStoppingRule

    def trainable(config):
        for i in range(15):
            tune.report({"score": config["q"] * (i + 1)})

    results = Tuner(
        trainable,
        param_space={"q": tune.grid_search([1, 2, 5, 6, 7, 8])},
        tune_config=TuneConfig(
            metric="score", mode="max",
            scheduler=MedianStoppingRule(grace_period=3,
                                         min_samples_required=3)),
    ).fit()
    assert results.get_best_result().config["q"] == 8
    lengths = [len(r.metrics_history) for r in results]
    assert min(lengths) < 15  # below-median trials were cut


def test_pbt_exploits_checkpoints(port_cluster):
    """Weak PBT trials must restart from a stronger trial's checkpoint with
    a mutated config (the EXPLOIT protocol)."""
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.tune import PopulationBasedTraining

    def trainable(config):
        ckpt = tune.get_checkpoint()
        level = ckpt.to_dict()["level"] if ckpt is not None else 0
        for i in range(12):
            level += config["rate"]
            tune.report({"level": level},
                        checkpoint=Checkpoint.from_dict({"level": level}))

    pbt = PopulationBasedTraining(
        perturbation_interval=3,
        hyperparam_mutations={"rate": tune.uniform(0.1, 10.0)},
        quantile_fraction=0.5, seed=3)
    results = Tuner(
        trainable,
        param_space={"rate": tune.grid_search([0.1, 0.2, 8.0, 9.0])},
        tune_config=TuneConfig(metric="level", mode="max", scheduler=pbt),
    ).fit()
    assert not results.errors
    assert pbt.num_perturbations > 0
    # An exploited weak trial inherits a strong trial's level: every trial's
    # final level should be far above what the weak configs alone reach
    # (0.2-rate trial alone caps at 12*0.2 = 2.4 without exploiting).
    final_levels = sorted(
        max(h["level"] for h in r.metrics_history) for r in results)
    assert final_levels[0] > 2.4


def test_tpe_searcher_converges(port_cluster):
    from ray_tpu_torch.tune import TPESearcher

    def trainable(config):
        x = config["x"]
        tune.report({"loss": (x - 3.0) ** 2})

    results = Tuner(
        trainable,
        param_space={"x": tune.uniform(-10.0, 10.0)},
        tune_config=TuneConfig(metric="loss", mode="min", num_samples=30,
                               search_alg=TPESearcher(n_initial_points=8,
                                                      seed=0),
                               max_concurrent_trials=4),
    ).fit()
    assert len(results) == 30
    best = results.get_best_result()
    # TPE should get meaningfully closer to x=3 than random's expected best.
    assert abs(best.config["x"] - 3.0) < 1.5


def test_concurrency_limiter(port_cluster):
    from ray_tpu_torch.tune import BasicVariantGenerator, ConcurrencyLimiter

    def trainable(config):
        tune.report({"v": config["x"]})

    searcher = ConcurrencyLimiter(BasicVariantGenerator(num_samples=6),
                                  max_concurrent=2)
    results = Tuner(
        trainable,
        param_space={"x": tune.uniform(0, 1)},
        tune_config=TuneConfig(metric="v", mode="max", num_samples=6,
                               search_alg=searcher),
    ).fit()
    assert len(results) == 6
    assert not results.errors


def test_logger_callbacks(port_cluster, tmp_path):
    from ray_tpu_torch.tune import CSVLoggerCallback, JsonLoggerCallback

    def trainable(config):
        for i in range(3):
            tune.report({"step": i, "x": config["x"]})

    results = Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=TuneConfig(metric="x", mode="max"),
        run_config=RunConfig(
            name="exp", storage_path=str(tmp_path),
            callbacks=[CSVLoggerCallback(), JsonLoggerCallback()]),
    ).fit()
    assert not results.errors
    exp_dir = tmp_path / "exp"
    trial_dirs = [d for d in exp_dir.iterdir() if d.is_dir()]
    assert len(trial_dirs) == 2
    for d in trial_dirs:
        csv_lines = (d / "progress.csv").read_text().strip().splitlines()
        assert len(csv_lines) == 4  # header + 3 reports
        json_lines = (d / "result.json").read_text().strip().splitlines()
        assert len(json_lines) == 3
        import json as _json
        assert _json.loads((d / "params.json").read_text())["x"] in (1, 2)


def test_experiment_snapshot_and_restore(port_cluster, tmp_path):
    def trainable(config):
        tune.report({"v": config["x"] * 10})

    run_config = RunConfig(name="resume_exp", storage_path=str(tmp_path))
    results = Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=TuneConfig(metric="v", mode="max"),
        run_config=run_config,
    ).fit()
    assert len(results) == 3
    state_file = tmp_path / "resume_exp" / "experiment_state.json"
    assert state_file.exists()

    # Restore: all trials finished, so results come back without rerunning.
    restored = Tuner.restore(str(tmp_path / "resume_exp"), trainable)
    results2 = restored.fit()
    assert len(results2) == 3
    assert results2.get_best_result().metrics["v"] == 30


def test_restore_requeues_pending_variants(port_cluster, tmp_path):
    """A crash before all variants launch must not lose the unlaunched ones:
    the snapshot stores pending configs and restore requeues them."""
    import json as _json

    # Simulate a crashed run: 1 of 4 grid points finished, 3 still pending.
    exp_dir = tmp_path / "crashed"
    exp_dir.mkdir()
    state = {
        "metric": "v", "mode": "max", "num_samples": 1,
        "name": "crashed", "storage_path": str(tmp_path),
        "num_created": 1,
        "pending_configs": [{"x": 2}, {"x": 3}, {"x": 4}],
        "trials": [{"trial_id": "trial_00000_dead", "config": {"x": 1},
                    "done": True, "error": None,
                    "history": [{"v": 10, "training_iteration": 1}]}],
    }
    (exp_dir / "experiment_state.json").write_text(_json.dumps(state))

    def trainable(config):
        tune.report({"v": config["x"] * 10})

    results = Tuner.restore(str(exp_dir), trainable).fit()
    assert len(results) == 4
    assert results.get_best_result().metrics["v"] == 40


def test_bayesopt_search_beats_random_on_quadratic(port_cluster):
    """BayesOpt should concentrate samples near the optimum of a smooth
    1-D objective."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search import BayesOptSearch

    def objective(config):
        tune.report({"score": -(config["x"] - 0.7) ** 2})

    tuner = tune.Tuner(
        objective,
        param_space={"x": tune.uniform(0.0, 1.0)},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=20,
            search_alg=BayesOptSearch(n_initial_points=5, seed=1)),
    )
    results = tuner.fit()
    best = results.get_best_result()
    assert abs(best.config["x"] - 0.7) < 0.15, best.config


def test_tbx_logger_writes_valid_event_file(tmp_path, port_cluster):
    """The hand-encoded TFRecord framing must round-trip: length-prefixed
    records with valid masked CRC32C."""
    import struct
    from ray_tpu_torch.tune.callbacks import (TBXLoggerCallback, _CRC32C_TABLE,
                                        _tb_events_record)

    cb = TBXLoggerCallback(str(tmp_path))
    cb.on_trial_result("trial1", {"loss": 0.5, "training_iteration": 1})
    cb.on_trial_result("trial1", {"loss": 0.25, "training_iteration": 2})
    cb.on_trial_complete("trial1")
    files = list((tmp_path / "trial1").glob("events.out.tfevents.*"))
    assert len(files) == 1
    raw = files[0].read_bytes()

    def crc32c(data):
        crc = 0xFFFFFFFF
        for b in data:
            crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF

    def unmask(m):
        rot = (m - 0xA282EAD8) & 0xFFFFFFFF
        return ((rot << 15) | (rot >> 17)) & 0xFFFFFFFF

    records = []
    off = 0
    while off < len(raw):
        (length,) = struct.unpack_from("<Q", raw, off)
        (len_crc,) = struct.unpack_from("<I", raw, off + 8)
        assert unmask(len_crc) == crc32c(raw[off:off + 8])
        payload = raw[off + 12:off + 12 + length]
        (pay_crc,) = struct.unpack_from("<I", raw, off + 12 + length)
        assert unmask(pay_crc) == crc32c(payload)
        records.append(payload)
        off += 12 + length + 4
    # header + 2 result events (each carrying >= 1 scalar)
    assert len(records) >= 3
    assert b"brain.Event:2" in records[0]
    assert b"ray/tune/loss" in b"".join(records[1:])


def test_syncer_callback_mirrors_experiment_dir(tmp_path, port_cluster):
    from ray_tpu_torch.tune.callbacks import SyncerCallback

    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "result.json").write_text("{}")
    dest = tmp_path / "bucket"
    cb = SyncerCallback(f"file://{dest}")
    cb.setup(experiment_dir=str(exp))
    cb.on_trial_result("t1", {"a": 1})
    assert (dest / "exp" / "result.json").exists()


def test_wandb_mlflow_gated():
    from ray_tpu_torch.tune.callbacks import (MLflowLoggerCallback,
                                        WandbLoggerCallback)
    with pytest.raises(ImportError):
        WandbLoggerCallback(project="p").setup()
    with pytest.raises(ImportError):
        MLflowLoggerCallback().setup()


def test_bayesopt_loguniform_domain(port_cluster):
    """LogUniform params must survive the GP phase (log_low/log_high)."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search import BayesOptSearch

    def objective(config):
        import math
        tune.report({"score": -abs(math.log10(config["lr"]) + 2.0)})

    tuner = tune.Tuner(
        objective,
        param_space={"lr": tune.loguniform(1e-4, 1e-1)},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=12,
            search_alg=BayesOptSearch(n_initial_points=4, seed=2)),
    )
    best = tuner.fit().get_best_result()
    assert 1e-4 <= best.config["lr"] <= 1e-1


def test_bohb_budget_model_selection():
    """BOHB models the largest budget with enough samples; below the
    threshold it pools across budgets (reference: tune/search/bohb
    pairing with HyperBand rungs)."""
    from ray_tpu_torch.tune import BOHBSearcher
    s = BOHBSearcher(min_points_per_budget=3, seed=0)
    s.set_search_properties("loss", "min", {"x": tune.uniform(0, 1)})
    for i in range(2):
        s._observe({"x": 0.1 * i}, {"loss": 1.0,
                                    "training_iteration": 9}, False)
    for i in range(4):
        s._observe({"x": 0.2 * i}, {"loss": 2.0,
                                    "training_iteration": 3}, False)
    # Budget 9 has only 2 points -> model falls to budget 3 (4 points).
    assert s.model_budget() == 3
    assert len(s._observations) == 4
    s._observe({"x": 0.9}, {"loss": 0.5, "training_iteration": 9}, False)
    assert s.model_budget() == 9
    assert len(s._observations) == 3


def test_bohb_with_hyperband_converges(port_cluster):
    """The BOHB pairing end to end: HyperBand rungs produce mixed-budget
    completions; the searcher still homes in on the optimum."""
    from ray_tpu_torch.tune import BOHBSearcher, HyperBandScheduler

    def trainable(config):
        x = config["x"]
        for i in range(8):
            tune.report({"loss": (x - 3.0) ** 2 + 0.1 / (i + 1)})

    results = Tuner(
        trainable,
        param_space={"x": tune.uniform(-10.0, 10.0)},
        tune_config=TuneConfig(
            metric="loss", mode="min", num_samples=30,
            search_alg=BOHBSearcher(n_initial_points=8, seed=0),
            scheduler=HyperBandScheduler(max_t=8, metric="loss",
                                         mode="min"),
            max_concurrent_trials=4),
    ).fit()
    assert len(results) == 30
    best = results.get_best_result()
    assert abs(best.config["x"] - 3.0) < 1.5


# ---------------------------------------------------------------------------
# Tune over TorchTrainer against Tune over JaxTrainer: gpt-tiny
# ---------------------------------------------------------------------------

GPT_LRS = [1e-3, 3e-3]
GPT_STEPS = 2


def _gpt_batch():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 256, (8, 32), dtype=np.int32),
            "targets": rng.integers(0, 256, (8, 32), dtype=np.int32)}


def _jax_gpt_loop(config):
    """gpt-tiny from seed 0 through the JAX package's train step at the
    trial's learning rate, reporting each step's loss."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.air import session as jsession
    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import MeshConfig, build_mesh, dp_rules
    from ray_tpu.parallel import train_step as jts

    cfg = jgpt.config("gpt-tiny")
    mesh = build_mesh(MeshConfig(dp=1, fsdp=1, tp=1),
                      devices=jax.devices("cpu")[:1])
    opt = jts.default_optimizer(learning_rate=config["lr"], warmup_steps=1)
    batch = {k: jnp.asarray(v) for k, v in _gpt_batch().items()}
    with jax.default_matmul_precision("highest"):
        state = jts.init_train_state(cfg, mesh, dp_rules(), opt, seed=0)
        step = jts.make_train_step(cfg, mesh, dp_rules(), opt)
        for i in range(GPT_STEPS):
            state, metrics = step(state, batch)
            jsession.report({"loss": float(metrics["loss"]), "step": i + 1})


def _torch_gpt_loop(config):
    """The same from the JAX package's initial parameters through the
    port's train step."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import train_step as ts

    cfg = gpt.config("gpt-tiny")
    opt = ts.default_optimizer(learning_rate=config["lr"], warmup_steps=1)
    model = gpt.from_jax_params(config["params"], cfg, "cpu")
    state = {"params": model,
             "opt_state": opt.init(dict(model.named_parameters()),
                                   gpt.leaf_groups(model)),
             "step": torch.zeros((), dtype=torch.int32)}
    step = ts.make_train_step(cfg, optimizer=opt)
    batch = {k: torch.from_numpy(v) for k, v in _gpt_batch().items()}
    for i in range(GPT_STEPS):
        state, metrics = step(state, batch)
        session.report({"loss": float(metrics["loss"]), "step": i + 1})


def _jax_params0():
    import jax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import MeshConfig, build_mesh, dp_rules
    from ray_tpu.parallel import train_step as jts

    cfg = jgpt.config("gpt-tiny")
    mesh = build_mesh(MeshConfig(dp=1, fsdp=1, tp=1),
                      devices=jax.devices("cpu")[:1])
    opt = jts.default_optimizer(learning_rate=1e-3, warmup_steps=1)
    state = jts.init_train_state(cfg, mesh, dp_rules(), opt, seed=0)
    return jax.tree_util.tree_map(np.asarray, state["params"])


def _losses_by_lr(results):
    return {r.config["lr"]: [m["loss"] for m in r.metrics_history]
            for r in results}


@pytest.fixture
def rendezvous_env_restored():
    """JaxTrainer's backend writes its ranks' RAY_TPU_WORLD_SIZE and
    RAY_TPU_RANK into ``os.environ``, which threads of this process share:
    put the variables back as they were, so that later tests in the
    process see none of them."""
    keys = ("RAY_TPU_WORLD_SIZE", "RAY_TPU_RANK")
    saved = {k: os.environ.get(k) for k in keys}
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_tune_over_torch_trainer_reports_jax_trainers_losses(
        ray_start_regular, port_cluster, rendezvous_env_restored):
    """The same grid over TorchTrainer and over JaxTrainer: each trial's
    losses, step by step, and the same best trial."""
    from ray_tpu import tune as jtune
    from ray_tpu.air import ScalingConfig as JScalingConfig
    from ray_tpu.train import JaxTrainer

    want = jtune.Tuner(
        JaxTrainer(_jax_gpt_loop,
                   scaling_config=JScalingConfig(num_workers=1)),
        param_space={"lr": jtune.grid_search(GPT_LRS)},
        tune_config=jtune.TuneConfig(metric="loss", mode="min")).fit()
    got = Tuner(
        TorchTrainer(_torch_gpt_loop,
                     train_loop_config={"params": _jax_params0()},
                     scaling_config=ScalingConfig(num_workers=1)),
        param_space={"lr": tune.grid_search(GPT_LRS)},
        tune_config=TuneConfig(metric="loss", mode="min")).fit()
    assert not want.errors and not got.errors
    want_losses, got_losses = _losses_by_lr(want), _losses_by_lr(got)
    assert sorted(got_losses) == sorted(want_losses) == GPT_LRS
    for lr in GPT_LRS:
        assert len(got_losses[lr]) == GPT_STEPS
        np.testing.assert_allclose(got_losses[lr], want_losses[lr],
                                   rtol=STEP_RTOL, err_msg=f"lr {lr}")
    assert got.get_best_result().config["lr"] == \
        want.get_best_result().config["lr"]


# ---------------------------------------------------------------------------
# with_resources: "gpu" is the card, a TPU is refused
# ---------------------------------------------------------------------------

def test_with_resources_maps_gpu_to_the_card():
    for key in ("gpu", "GPU", "num_gpus"):
        def trainable(config):
            pass
        assert tune.with_resources(trainable, {key: 0.5, "cpu": 2}
                                   )._tune_resources == {"num_gpus": 0.5,
                                                         "num_cpus": 2}
    for key in ("tpu", "TPU", "num_tpus"):
        with pytest.raises(ValueError, match=repr(key)):
            tune.with_resources(lambda config: None, {key: 1})


def test_a_trial_with_a_gpu_holds_the_card(one_card):
    """Two one-card trials on a one-card cluster: each holds the card
    while it runs, one after the other, and the card is free again after
    fit()."""
    def trainable(config):
        for _ in range(2):
            tune.report({"free": ray_tpu_torch.available_resources().get(
                "GPU", 0), "t": time.monotonic()})
            time.sleep(0.2)

    results = Tuner(tune.with_resources(trainable, {"gpu": 1}),
                    param_space={"x": tune.grid_search([0, 1])},
                    tune_config=TuneConfig(metric="t", mode="max")).fit()
    assert not results.errors
    spans = sorted((r.metrics_history[0]["t"], r.metrics_history[-1]["t"])
                   for r in results)
    assert all(m["free"] == 0 for r in results for m in r.metrics_history)
    assert spans[0][1] <= spans[1][0], spans  # never both at once
    assert ray_tpu_torch.available_resources().get("GPU") == 1


# ---------------------------------------------------------------------------
# The stop and kill paths: no gang process outlives its trial
# ---------------------------------------------------------------------------

def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _wait_released(cpus, gpus, timeout=20.0):
    """The runtime's available CPUs and GPUs back at ``cpus``, ``gpus``."""
    deadline = time.monotonic() + timeout
    while True:
        avail = ray_tpu_torch.available_resources()
        got = (avail.get("CPU", 0), avail.get("GPU", 0))
        if got == (cpus, gpus) or time.monotonic() > deadline:
            return got
        time.sleep(0.05)


def _gang_pids_loop_fn():
    def loop():
        """A rank that reports its process for up to 200 steps."""
        import os
        import time

        from ray_tpu_torch.air import session
        for i in range(200):
            session.report({"pid": os.getpid(), "i": i, "visible":
                            os.environ.get("CUDA_VISIBLE_DEVICES")})
            time.sleep(0.01)
    return loop


# A nested function: cloudpickle ships it by value to worker processes,
# which cannot import this test module.
_gang_pids_loop = _gang_pids_loop_fn()


@pytest.mark.parametrize("lease", ["cpu", "gpu"])
def test_a_stopped_trial_leaves_no_gang_process(one_card, lease):
    """stop={"training_iteration": 1}: two trials over a trainer whose
    rank runs in a worker process (TorchTrainer over gloo, or a GPU lease
    of half the card each, both trials on it at once); once fit()
    returns, every rank's process has exited and every lease is back."""
    if lease == "cpu":
        trainer = TorchTrainer(_gang_pids_loop, scaling_config=ScalingConfig(
            num_workers=1, runtime_env={"worker_process": True}))
    else:
        trainer = DataParallelTrainer(_gang_pids_loop, scaling_config=(
            ScalingConfig(num_workers=1, use_gpu=True,
                          resources_per_worker={"GPU": 0.5},
                          runtime_env={"worker_process": True})))
    results = Tuner(trainer, param_space={"x": tune.grid_search([0, 1])},
                    tune_config=TuneConfig(metric="i", mode="max",
                                           max_concurrent_trials=2),
                    run_config=RunConfig(
                        stop={"training_iteration": 1})).fit()
    assert not results.errors
    pids = set()
    for r in results:
        # Stopped at its first result; a result already on its way when
        # the stop was sent still lands (as tests/test_tune.py's
        # test_stop_criteria allows).
        assert len(r.metrics_history) <= 3
        pids |= {m["pid"] for m in r.metrics_history}
        if lease == "gpu":
            assert r.metrics["visible"] == "0"
    assert len(pids) == 2 and os.getpid() not in pids
    assert not [p for p in pids if _alive(p)]
    assert _wait_released(8, 1) == (8, 1)


# The PBT trials' ranks that are up (the trials are thread actors of this
# process): each trial reports only once both first trials have a rank,
# so the scheduler compares them whatever the host's load.
_PBT_RANKS = []


def _pbt_trainable(config):
    """A trial that holds a worker-process actor on half the card (its
    gang) while it reports, and ends it when the trial stops."""
    @ray_tpu_torch.remote(num_gpus=0.5, runtime_env={"worker_process": True})
    class Rank:
        def pid(self):
            import os
            return os.getpid()

    rank = Rank.remote()
    try:
        pid = ray_tpu_torch.get(rank.pid.remote())
        _PBT_RANKS.append(pid)
        deadline = time.monotonic() + 60
        while len(_PBT_RANKS) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        ckpt = tune.get_checkpoint()
        level = ckpt.to_dict()["level"] if ckpt is not None else 0
        for _ in range(6):
            level += config["rate"]
            tune.report({"level": level, "pid": pid},
                        checkpoint=Checkpoint.from_dict({"level": level}))
            time.sleep(0.05)
    finally:
        ray_tpu_torch.kill(rank)


def test_a_pbt_exploit_leaves_no_gang_process(one_card):
    """A PBT exploit restarts the weak trial: its old gang is ended and
    its half of the card returned before the restarted trial asks for
    one (on a one-card cluster it could not be placed otherwise); after
    fit() no rank's process remains and the card is free."""
    from ray_tpu_torch.tune import PopulationBasedTraining

    _PBT_RANKS.clear()
    pbt = PopulationBasedTraining(
        perturbation_interval=2,
        hyperparam_mutations={"rate": tune.uniform(0.1, 10.0)},
        quantile_fraction=0.5, seed=3)
    results = Tuner(
        _pbt_trainable,
        param_space={"rate": tune.grid_search([0.1, 9.0])},
        tune_config=TuneConfig(metric="level", mode="max", scheduler=pbt,
                               max_concurrent_trials=2),
    ).fit()
    assert not results.errors
    assert pbt.num_perturbations > 0
    pids = {m["pid"] for r in results for m in r.metrics_history}
    assert len(pids) > 2  # an exploited trial restarted with a new gang
    assert not [p for p in pids if _alive(p)]
    assert _wait_released(8, 1) == (8, 1)

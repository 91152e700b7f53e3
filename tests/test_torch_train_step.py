"""The port's train step and optimizers against the JAX package's and optax.

The JAX side runs ``ray_tpu.parallel.train_step`` on a one-CPU-device mesh
under "highest" matmul precision; the port starts from the same parameters
(carried with ``from_jax_params``) and takes the same batches, made with
numpy from a fixed seed. The optimizers are also held to optax itself on a
parameter tree with a layer-stacked leaf, since optax's block-RMS steps
span all layers of such a leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel import MeshConfig, build_mesh, dp_rules
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.parallel import train_step as tts

# 5 fp32 steps of gpt-tiny: the losses and updated parameters differ only
# by the two frameworks' summation orders, carried through the optimizer
# (the bound of test_model_parallel.py's accumulation test, rel 1e-5).
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-6
# optax against the port on the same gradients: fp32 arithmetic in the
# same order, up to the sums inside norms and means; the parameters are
# of order 1-10, where 1e-6 is a few fp32 ulps.
OPTAX_TOL = 1e-6

OPTIMIZERS = {
    "adamw": (lambda m: m.default_optimizer(1e-3, warmup_steps=2)),
    "adafactor": (lambda m: m.memory_efficient_optimizer(1e-2,
                                                         warmup_steps=2)),
}


def _batches(n, B=4, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 256, (B, S), dtype=np.int32),
             "targets": rng.integers(0, 256, (B, S), dtype=np.int32),
             "mask": rng.integers(0, 2, (B, S)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_train_step_matches_jax(opt, accum):
    cfg = jgpt.config("gpt-tiny")
    mesh = build_mesh(MeshConfig(dp=1, fsdp=1, tp=1),
                      devices=jax.devices("cpu")[:1])
    jopt = OPTIMIZERS[opt](jts)
    batches = _batches(5)
    with jax.default_matmul_precision("highest"):
        state = jts.init_train_state(cfg, mesh, dp_rules(), jopt, seed=0)
        params0 = jax.tree_util.tree_map(np.asarray, state["params"])
        step = jts.make_train_step(cfg, mesh, dp_rules(), jopt,
                                   accum_steps=accum)
        ref_losses = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            ref_losses.append(float(m["loss"]))
        ref_params = jax.tree_util.tree_map(np.asarray, state["params"])

    tcfg = tgpt.config("gpt-tiny")
    topt = OPTIMIZERS[opt](tts)
    model = tgpt.from_jax_params(params0, tcfg, "cpu")
    tstate = {"params": model,
              "opt_state": topt.init(dict(model.named_parameters()),
                                     tgpt.leaf_groups(model)),
              "step": torch.zeros((), dtype=torch.int32)}
    tstep = tts.make_train_step(tcfg, optimizer=topt, accum_steps=accum)
    losses = []
    for b in batches:
        tstate, m = tstep(tstate, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        assert all(m[k].shape == () for k in tts.METRICS)
        losses.append(float(m["loss"]))
    assert int(tstate["step"]) == 5 and tstate["params"] is model
    np.testing.assert_allclose(losses, ref_losses, rtol=STEP_RTOL)
    got = tgpt.to_jax_params(model)
    for name in ref_params:
        want = ref_params[name]
        for key, arr in (want.items() if name == "layers"
                         else [(name, want)]):
            have = got["layers"][key] if name == "layers" else got[key]
            np.testing.assert_allclose(have, arr, atol=PARAM_ATOL,
                                       rtol=STEP_RTOL, err_msg=key)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_first_update_leaves_every_parameter_unchanged(opt):
    """The schedule starts at 0, so the first update is exactly zero."""
    cfg = tgpt.config("gpt-tiny")
    optimizer = OPTIMIZERS[opt](tts)
    state = tts.init_train_state(cfg, optimizer=optimizer, seed=3,
                                 device="cpu")
    before = {n: p.detach().clone()
              for n, p in state["params"].named_parameters()}
    b = _batches(1)[0]
    state, m = tts.make_train_step(cfg, optimizer=optimizer)(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    for n, p in state["params"].named_parameters():
        assert torch.equal(p, before[n]), n
    assert torch.isfinite(m["loss"])


# A tree in the JAX layout with layer-stacked leaves whose layers differ in
# scale, so that an RMS per layer and the RMS over the stacked leaf differ.
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    layer_scale = np.array([1.0, 3.0, 0.2], np.float32)
    return {"layers": {
        # factored on axes 1 and 3 of the stacked shape (0 and 2 per layer)
        "w": (rng.standard_normal((3, 256, 4, 130), dtype=np.float32)
              * layer_scale[:, None, None, None]),
        "b": (rng.standard_normal((3, 64), dtype=np.float32)
              * layer_scale[:, None])},
        "e": rng.standard_normal((300, 130), dtype=np.float32),
        "s": rng.standard_normal((5,), dtype=np.float32)}


def _to_port(tree):
    out = {}
    for name, arr in tree["layers"].items():
        for i in range(arr.shape[0]):
            out[f"blocks.{i}.{name}"] = torch.from_numpy(arr[i].copy())
    out.update({k: torch.from_numpy(np.array(v)) for k, v in tree.items()
                if k != "layers"})
    return out


def _port_groups(tree):
    groups = {f"layers.{name}": [f"blocks.{i}.{name}"
                                 for i in range(arr.shape[0])]
              for name, arr in tree["layers"].items()}
    groups.update({k: [k] for k in tree if k != "layers"})
    return groups


def _from_port(params):
    layers = {}
    for name in ("w", "b"):
        layers[name] = np.stack([params[f"blocks.{i}.{name}"].numpy()
                                 for i in range(3)])
    return {"layers": layers, "e": params["e"].numpy(),
            "s": params["s"].numpy()}


def _optax_pair(opt):
    jsched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10)
    tsched = optim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10)
    if opt == "adamw":
        return (optax.chain(optax.clip_by_global_norm(1.0),
                            optax.adamw(jsched, b1=0.9, b2=0.95,
                                        weight_decay=0.1)),
                optim.chain(optim.clip_by_global_norm(1.0),
                            optim.adamw(tsched, b1=0.9, b2=0.95,
                                        weight_decay=0.1)))
    return (optax.chain(optax.clip_by_global_norm(1.0),
                        optax.adafactor(learning_rate=jsched, momentum=None)),
            optim.chain(optim.clip_by_global_norm(1.0),
                        optim.adafactor(learning_rate=tsched)))


@pytest.mark.parametrize("grad_scale", [1.0, 1e-3])
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizer_matches_optax_on_a_layer_stacked_tree(opt, grad_scale):
    jopt, topt = _optax_pair(opt)
    tree = _tree()
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = _to_port(tree)
    jstate, tstate = jopt.init(jparams), topt.init(tparams,
                                                   _port_groups(tree))
    rng = np.random.default_rng(1)
    for i in range(5):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * grad_scale)
            .astype(np.float32), tree)
        jupd, jstate = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        tgrads = _to_port(grads)
        tupd, tstate = topt.update(tgrads, tstate, tparams)
        # in place: the gradients became the updates
        assert all(tupd[n] is g for n, g in tgrads.items())
        if i == 0:  # the schedule starts at 0: the first update is zero
            assert all(float(u.abs().max()) == 0 for u in tupd.values())
        optim.apply_updates(tparams, tupd)
        got = _from_port(tparams)
        for (path, want) in jax.tree_util.tree_flatten_with_path(jparams)[0]:
            have = got
            for key in path:
                have = have[key.key]
            np.testing.assert_allclose(have, np.asarray(want),
                                       rtol=OPTAX_TOL, atol=OPTAX_TOL,
                                       err_msg=f"step {i} {path}")


def test_leaf_groups_must_name_every_parameter_once():
    params = {"a": torch.zeros(3), "b": torch.zeros(3)}
    opt = optim.adafactor(optim.warmup_cosine_decay_schedule(
        0.0, 1e-3, 1, 10))
    for groups in ({"x": ["a"]}, {"x": ["a", "b"], "y": ["b"]}):
        with pytest.raises(ValueError, match="every parameter once"):
            opt.init(params, groups)


def test_schedule_matches_optax():
    for args in [(0.0, 1e-3, 100, 10_000), (0.0, 1e-4, 2, 10),
                 (0.5, 1.0, 0, 10, 0.1)]:
        ref = optax.warmup_cosine_decay_schedule(*args)
        got = optim.warmup_cosine_decay_schedule(*args)
        for count in (0, 1, 2, 3, 50, 99, 100, 101, 5_000, 9_999, 20_000):
            want = float(ref(count))
            assert float(got(torch.tensor(count, dtype=torch.int32))) == \
                pytest.approx(want, rel=1e-6, abs=1e-12), (args, count)


def test_adafactor_refuses_to_factor_over_the_layer_axis():
    params = {f"blocks.{i}.w": torch.zeros((130, 4)) for i in range(200)}
    with pytest.raises(NotImplementedError, match="layer axis"):
        optim.adafactor(optim.warmup_cosine_decay_schedule(
            0.0, 1e-3, 1, 10)).init(params, {"layers.w": list(params)})


def test_eval_step_returns_the_loss_without_grads():
    cfg = tgpt.config("gpt-tiny")
    state = tts.init_train_state(cfg, seed=0, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    metrics = tts.make_eval_step(cfg)(state["params"], b)
    loss, _ = tgpt.loss_fn(state["params"], b["tokens"], b["targets"],
                           b["mask"])
    assert float(metrics["loss"]) == pytest.approx(float(loss.detach()),
                                                   rel=1e-6)
    assert all(p.grad is None for p in state["params"].parameters())


def test_init_train_state_is_seeded_and_on_the_named_device():
    cfg = tgpt.config("gpt-tiny")
    a = tts.init_train_state(cfg, seed=5, device="cpu")
    b = tts.init_train_state(cfg, seed=5, device="cpu")
    assert a["step"].dtype == torch.int32 and int(a["step"]) == 0
    for (n, p), (_, q) in zip(a["params"].named_parameters(),
                              b["params"].named_parameters()):
        assert p.device.type == "cpu" and torch.equal(p, q), n
    assert a["opt_state"][1][0]["count"].shape == ()


def test_init_train_state_gives_adafactor_the_stacked_leaves():
    """Adafactor's block RMS spans each JAX leaf: the state holds the
    model's leaf groups, one per leaf, every layer's tensor in its own."""
    cfg = tgpt.config("gpt-tiny")
    state = tts.init_train_state(
        cfg, optimizer=tts.memory_efficient_optimizer(1e-3), device="cpu")
    adafactor = state["opt_state"][1]
    want = tgpt.leaf_groups(state["params"])
    assert adafactor[1]["groups"] == want and adafactor[3]["groups"] == want
    assert len(want["layers.wq"]) == cfg.n_layers


def test_init_train_state_needs_the_card_unless_given_the_cpu(monkeypatch):
    cfg = tgpt.config("gpt-tiny")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tts.init_train_state(cfg)


def test_step_refuses_a_model_of_another_config():
    state = tts.init_train_state(tgpt.config("gpt-tiny"), device="cpu")
    step = tts.make_train_step(tgpt.config("gpt-tiny", loss_chunk=64))
    b = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    with pytest.raises(ValueError, match="config"):
        step(state, b)

"""The port's ViT against ``ray_tpu.models.vit`` with carried-over weights.

Parameters are drawn with numpy from a seed into the JAX package's
parameter tree, every leaf random (``tests/_torch_zoo.py``), and carried
into the port by ``from_jax_params``; images and labels are made with
numpy from a fixed seed. The JAX side runs under "highest" matmul
precision, so both sides sum the same fp32 products, in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import vit as jv
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import vit as tv
from ray_tpu_torch.parallel import sharding as tsharding

from _torch_zoo import (assert_adam_steps_match, assert_grads_match,
                        assert_round_trip, assert_specs_match, jax_params,
                        jax_value_and_grad)

PRESET = "vit-tiny"
# fp32 logits through 2 layers: summation order only (1e-4 is
# tests/test_torch_gpt.py's bound); loss to 1e-6 relative, every leaf's
# gradient to 1e-5.
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
# bf16 on both sides: logits reach |2.3|, where a bf16 ulp is 2^-6; over 4
# input seeds the gap was 0.0156 (one ulp), and each package's own bf16 is
# 0.012-0.023 from its fp32. 2^-4 is 4 ulps there; a wrong scale or
# patch order moves logits by O(1).
BF16_TOL = 2.0 ** -4
COUNTS = {"vit-b16": 86_530_792}
# ``loss_fn`` over a batch (images, labels); remat changes no value.
_VALUE_AND_GRAD = jax_value_and_grad(
    lambda p, batch: jv.loss_fn(p, jv.config(PRESET), *batch))


def _images(B=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, 32, 32, 3)).astype(np.float32)


def _model(cfg=None, params=None):
    return tv.from_jax_params(params or jax_params(jv, PRESET),
                              cfg or tv.config(PRESET), "cpu")


def test_from_jax_params_round_trip_is_exact():
    model = _model()
    assert_round_trip(jax_params(jv, PRESET), model)
    assert tv.leaf_groups(model)["layers.wq"] == ["blocks.0.wq",
                                                  "blocks.1.wq"]


def test_from_jax_params_rejects_wrong_shapes():
    with pytest.raises(ValueError, match="does not match"):
        tv.from_jax_params(jax_params(jv, PRESET),
                           tv.config(PRESET, d_model=32), "cpu")


@pytest.mark.parametrize("preset", sorted(jv.PRESETS))
def test_config_counts_match_jax(preset):
    jcfg, tcfg = jv.config(preset), tv.config(preset)
    assert tcfg.num_params() == jcfg.num_params()
    assert tv.flops_per_image(tcfg) == jv.flops_per_image(jcfg)
    for field in ("seq_len", "patch_dim", "n_patches", "head_dim", "remat",
                  "pool", "layernorm_eps"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert tcfg.dtype == getattr(torch, np.dtype(jcfg.dtype).name)
    count = sum(p.numel() for p in tv.ViT(tcfg, "meta").parameters())
    assert count == tcfg.num_params() == COUNTS.get(preset, count)


def test_patchify_orders_each_patch_rows_then_columns_then_channels():
    """The mirror of test_models.py's test_vit_patchify_roundtrip, and the
    whole tensor against the JAX package's."""
    cfg = tv.config(PRESET)
    imgs = _images()
    patches = tv.patchify(cfg, torch.from_numpy(imgs)).numpy()
    assert patches.shape == (2, cfg.n_patches, cfg.patch_dim)
    np.testing.assert_array_equal(patches[0, 0],
                                  imgs[0, :8, :8, :].reshape(-1))
    np.testing.assert_array_equal(patches[1, 5],
                                  imgs[1, 8:16, 8:16, :].reshape(-1))
    np.testing.assert_array_equal(
        patches, np.asarray(jv.patchify(jv.config(PRESET), imgs)))


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_forward_matches_jax(pool):
    params = jax_params(jv, PRESET, pool=pool)
    imgs = _images()
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jv.forward, static_argnums=1)(
            params, jv.config(PRESET, pool=pool), imgs))
    model = _model(tv.config(PRESET, pool=pool), params)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), ref, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, (4,)).astype(np.int32))


def _port_loss(model, batch):
    return tv.loss_fn(model, *map(torch.from_numpy, batch))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(remat):
    batch = _batch(1)
    (ref_loss, ref_m), ref_g = _VALUE_AND_GRAD(jax_params(jv, PRESET), batch)
    model = _model(tv.config(PRESET, remat=remat))
    loss, metrics = _port_loss(model, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=LOSS_RTOL)
    for key in ("loss", "accuracy"):
        assert not metrics[key].requires_grad
        np.testing.assert_allclose(float(metrics[key]), float(ref_m[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert_grads_match(model, ref_g, GRAD_TOL)


def test_adam_steps_match_optax():
    assert_adam_steps_match(_VALUE_AND_GRAD,
                            lambda model, b: _port_loss(model, b)[0],
                            jax_params(jv, PRESET), _model(),
                            [_batch(3 + i) for i in range(3)])


def test_bf16_forward_matches_jax():
    params = jax_params(jv, PRESET)
    imgs = _images(seed=4)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jv.forward, static_argnums=1)(
            params, jv.config(PRESET, dtype=jnp.bfloat16), imgs))
    model = _model(tv.config(PRESET, dtype=torch.bfloat16), params)
    dtypes = []
    for block in model.blocks:
        block.register_forward_hook(
            lambda mod, args, out: dtypes.append((args[0].dtype, out.dtype)))
    with torch.no_grad():
        got = model(torch.from_numpy(imgs))
    assert dtypes == [(torch.bfloat16, torch.bfloat16)] * 2
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=BF16_TOL, rtol=0)


def test_training_learns():
    """The mirror of test_models.py's test_vit_training_learns: two
    trivially separable classes, 20 SGD steps at lr 0.05."""
    cfg = tv.config(PRESET)
    model = tv.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(np.concatenate([
        rng.normal(2.0, 0.1, (8, 32, 32, 3)),
        rng.normal(-2.0, 0.1, (8, 32, 32, 3))]).astype(np.float32))
    labels = torch.tensor([0] * 8 + [1] * 8)
    params = list(model.parameters())
    for _ in range(20):
        loss, metrics = tv.loss_fn(model, images, labels)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(0.05 * g)
    assert float(metrics["accuracy"]) >= 0.9


def test_init_distributions():
    cfg = tv.config(PRESET)
    a = tv.init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = tv.init(cfg, torch.Generator().manual_seed(0), "cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert float(a.patch_proj.std()) == pytest.approx(0.02, rel=0.05)
    assert torch.all(a.blocks[0].ln1_scale == 1)
    assert torch.all(a.blocks[1].b_in == 0)


@pytest.mark.parametrize("preset", ["dp_rules", "fsdp_rules", "tp_fsdp_rules",
                                    "context_parallel_rules"])
def test_param_specs_are_the_jax_specs_without_the_layer_axis(preset):
    port = tv.param_specs(tv.config(PRESET), getattr(tsharding, preset)())
    ref = jv.param_specs(jv.config(PRESET), getattr(jsharding, preset)())
    assert_specs_match(port, ref, stacks=("layers",))
    assert tuple(tv.batch_spec(getattr(tsharding, preset)())) == tuple(
        jv.batch_spec(getattr(jsharding, preset)()))


def test_pipeline_rules_and_a_mesh_wait_for_later_items():
    with pytest.raises(NotImplementedError, match="item 12"):
        tv.param_specs(tv.config(PRESET), tsharding.ShardingRules(
            layers="pp"))
    # A mesh is placed on (ROADMAP item 13 is done); one that is not
    # build_mesh's raises.
    with pytest.raises(ValueError, match="build_mesh"):
        tv.init(tv.config(PRESET), torch.Generator(), "cpu", mesh=object())


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tv.config(PRESET)
    for build in (lambda: tv.ViT(cfg),
                  lambda: tv.init(cfg, torch.Generator()),
                  lambda: tv.from_jax_params(jax_params(jv, PRESET), cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert tv.ViT(cfg, device="cpu").head_w.device.type == "cpu"

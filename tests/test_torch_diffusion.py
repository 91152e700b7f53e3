"""The port's diffusion UNet and DDIM sampler against
``ray_tpu.models.diffusion`` with carried-over weights.

Parameters are drawn with numpy from a seed into the JAX package's
parameter tree, every leaf random (``tests/_torch_zoo.py``), and carried
into the port by ``from_jax_params``; inputs are made with numpy from a
fixed seed, and the JAX draws (``x_T``, ``t``, ``eps``) from the same key
splits that its sampler and loss make, passed to the port explicitly. The
JAX side runs under "highest" matmul precision, so both sides sum the
same fp32 products, in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import diffusion as jd
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import diffusion as td
from ray_tpu_torch.parallel import sharding as tsharding

from _torch_zoo import (assert_adam_steps_match, assert_grads_match,
                        assert_round_trip, assert_specs_match, flatten,
                        jax_params, jax_value_and_grad)

PRESET = "unet-tiny"
# fp32 through the UNet (7 res blocks, attention): summation order only.
# Outputs reach |2.4|, the sampled images |3| (x0 is clipped to [-3, 3]).
# A wrong padding, group or skip moves them by O(1).
FWD_TOL = 1e-6
SAMPLE_TOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
# bf16 on both sides: outputs reach |2.4|, where a bf16 ulp is 2^-6; XLA's
# bf16 silu and convolutions round differently from torch's, and over 4
# input seeds the gap was 0.023-0.031 (2 ulps), as large as each package's
# own bf16 from its fp32 (0.024-0.035 in JAX). 2^-4 is 4 ulps there; a
# wrong padding, group or skip moves outputs by O(1).
BF16_TOL = 2.0 ** -4
# Full-size presets: parameter counts of the JAX package's init.
COUNTS = {"ddpm-cifar": 20_235_267, "sd-base": 146_917_252}


def _model(cfg=None, params=None):
    return td.from_jax_params(params or jax_params(jd, PRESET),
                              cfg or td.config(PRESET), "cpu")


def _inputs(B=2, seed=0):
    cfg = jd.config(PRESET)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(
        (B, cfg.image_size, cfg.image_size, cfg.in_channels)).astype(
            np.float32)
    t = rng.integers(0, cfg.n_timesteps, (B,)).astype(np.int32)
    return x, t


# ``loss_fn`` over a batch (images, key).
_VALUE_AND_GRAD = jax_value_and_grad(
    lambda p, batch: jd.loss_fn(p, jd.config(PRESET), *batch))


def _jax_draws(key, shape, T):
    """``loss_fn``'s t and eps from ``key``, as the JAX package draws them."""
    k_t, k_eps = jax.random.split(key)
    return (np.asarray(jax.random.randint(k_t, (shape[0],), 0, T)),
            np.asarray(jax.random.normal(k_eps, shape, jnp.float32)))


def test_from_jax_params_round_trip_is_exact():
    params = jax_params(jd, PRESET)
    model = _model()
    assert_round_trip(params, model)
    # The optional leaves follow the JAX tree: a skip only where a block
    # changes width, a resample conv on all stages but one.
    groups = td.leaf_groups(model)
    assert "down.0.blocks.0.skip" not in groups
    assert "down.1.blocks.0.skip" in groups
    assert "down.0.down" in groups and "down.1.down" not in groups
    assert "up.0.up" in groups and "up.1.up" not in groups


def test_from_jax_params_rejects_wrong_shapes():
    with pytest.raises(ValueError, match="does not match"):
        td.from_jax_params(jax_params(jd, PRESET),
                           td.config(PRESET, base_channels=8), "cpu")


@pytest.mark.parametrize("preset", sorted(jd.PRESETS))
def test_config_counts_match_jax(preset):
    jcfg, tcfg = jd.config(preset), td.config(preset)
    assert tcfg.stage_channels == jcfg.stage_channels
    for field in ("image_size", "in_channels", "n_res_blocks", "n_groups",
                  "time_dim", "n_timesteps"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert tcfg.dtype == getattr(torch, np.dtype(jcfg.dtype).name)
    shapes = flatten(jd.init_shapes(jcfg))
    model = td.UNet(tcfg, "meta")
    named = dict(model.named_parameters())
    assert sorted(td.leaf_groups(model)) == sorted(shapes)
    for name, leaf in shapes.items():
        assert tuple(named[name].shape) == leaf.shape, name
    count = sum(p.numel() for p in model.parameters())
    assert count == sum(leaf.size for leaf in shapes.values())
    if preset in COUNTS:
        assert count == COUNTS[preset]


@pytest.mark.parametrize("size,kernel,stride", [
    (8, 3, 1), (7, 3, 1), (8, 3, 2), (7, 3, 2), (8, 1, 1), (5, 1, 1),
    (6, 3, 2), (9, 3, 2)])
def test_same_convolution_matches_lax(size, kernel, stride):
    """XLA pads a stride-2 "SAME" convolution of an even size by 0 before
    and 1 after; F.conv2d's padding=1 would shift the grid."""
    rng = np.random.default_rng(size * 10 + stride)
    x = rng.standard_normal((2, size, size + 1, 4)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 4, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jd._conv(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), stride=stride))
    got = td._conv(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), stride=stride).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T,n_steps", [(50, n) for n in range(2, 51)] + [
    (1000, n) for n in (2, 4, 10, 20, 25, 50, 100, 250, 500, 1000)])
def test_ddim_timesteps_equal_jnp_linspace(T, n_steps):
    """The sampler's integers, exactly: float32 truncation makes 665.99994
    665 at 10 steps of T 1000, where np.linspace gives 666."""
    ref = np.asarray(jnp.linspace(T - 1, 0, n_steps).astype(jnp.int32))
    got = td.ddim_timesteps(T, n_steps)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_ddim_timesteps_at_the_examples_default():
    assert td.ddim_timesteps(1000, 10).tolist() == [
        999, 888, 777, 665, 555, 443, 332, 221, 110, 0]


@pytest.mark.parametrize("T", [50, 1000])
def test_schedule_matches_jax(T):
    cfg = jd.config(PRESET, n_timesteps=T)
    betas, alphas_bar = td.make_schedule(td.config(PRESET, n_timesteps=T),
                                         "cpu")
    ref_b, ref_ab = map(np.asarray, jd.make_schedule(cfg))
    # XLA contracts some of linspace's products and sums into fused
    # multiply-adds: betas to one fp32 ulp (2^-22 relative at most), and
    # cumprod's T products to fp32 rounding per product.
    np.testing.assert_allclose(betas.numpy(), ref_b, rtol=2.0 ** -22,
                               atol=0)
    np.testing.assert_allclose(alphas_bar.numpy(), ref_ab, rtol=1e-5)


def test_timestep_embedding_matches_jax():
    t = np.arange(0, 1000, 37).astype(np.int32)
    ref = np.asarray(jd.timestep_embedding(jnp.asarray(t), 128))
    got = td.timestep_embedding(torch.from_numpy(t), 128).numpy()
    # fp32 angles up to 999 rad: sin and cos differ by an ulp of the angle.
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_forward_matches_jax():
    params = jax_params(jd, PRESET)
    x, t = _inputs()
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jd.forward, static_argnums=1)(
            params, jd.config(PRESET), x, t))
    with torch.no_grad():
        got = _model()(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=FWD_TOL, rtol=1e-4)


def _port_loss(model, batch):
    """The port's ``loss_fn`` on JAX's draws from the batch's key."""
    images, key = batch
    t, eps = _jax_draws(key, images.shape, td.config(PRESET).n_timesteps)
    return td.loss_fn(model, torch.from_numpy(images), t=torch.from_numpy(t),
                      eps=torch.from_numpy(eps))


def _images(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 16, 16, 3)) * 0.5).astype(np.float32)


def test_loss_and_gradients_match_jax():
    batch = (_images(1), jax.random.PRNGKey(5))
    (ref_loss, ref_m), ref_g = _VALUE_AND_GRAD(jax_params(jd, PRESET), batch)
    model = _model()
    loss, metrics = _port_loss(model, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=LOSS_RTOL)
    assert not metrics["loss"].requires_grad
    np.testing.assert_allclose(float(metrics["loss"]), float(ref_m["loss"]),
                               rtol=LOSS_RTOL)
    assert_grads_match(model, ref_g, GRAD_TOL)


def test_loss_draws_from_the_generator():
    model = _model()
    images = torch.zeros((2, 16, 16, 3))
    a = td.loss_fn(model, images, torch.Generator().manual_seed(3))[0]
    b = td.loss_fn(model, images, torch.Generator().manual_seed(3))[0]
    c = td.loss_fn(model, images, torch.Generator().manual_seed(4))[0]
    assert float(a) == float(b) != float(c)


def test_adam_steps_match_optax():
    batches = [(_images(2 + i), jax.random.PRNGKey(10 + i)) for i in range(3)]
    assert_adam_steps_match(_VALUE_AND_GRAD,
                            lambda model, b: _port_loss(model, b)[0],
                            jax_params(jd, PRESET), _model(), batches)


def test_bf16_forward_matches_jax():
    params = jax_params(jd, PRESET)
    x, t = _inputs(seed=3)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jd.forward, static_argnums=1)(
            params, jd.config(PRESET, dtype=jnp.bfloat16), x, t))
    model = _model(td.config(PRESET, dtype=torch.bfloat16), params)
    dtypes = []
    model.mid_attn.register_forward_hook(
        lambda mod, args, out: dtypes.append((args[0].dtype, out.dtype)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
    assert dtypes == [(torch.bfloat16, torch.bfloat16)]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=BF16_TOL, rtol=0)


def test_ddim_sample_matches_jax():
    """10 steps at eta 0 from the JAX sampler's own x_T."""
    params = jax_params(jd, PRESET)
    key = jax.random.PRNGKey(1)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jd.ddim_sample, static_argnums=(1, 3, 4))(
            params, jd.config(PRESET), key, 2, 10))
    x_T = np.asarray(jax.random.normal(jax.random.split(key)[0],
                                       ref.shape, jnp.float32))
    got = td.ddim_sample(_model(), None, 2, 10, x_T=torch.from_numpy(x_T))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=SAMPLE_TOL, rtol=0)


def test_ddim_sample_with_eta_draws_noise_from_the_generator():
    model = _model()
    a, b, c = (td.ddim_sample(model, torch.Generator().manual_seed(s), 1, 3,
                              eta=eta) for s, eta in ((0, 1.0), (0, 1.0),
                                                      (0, 0.0)))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_timestep_conditioning():
    """The mirror of test_models.py's test_unet_timestep_conditioning."""
    model = td.init(td.config(PRESET), torch.Generator().manual_seed(0),
                    "cpu")
    x = torch.from_numpy(_inputs(B=1)[0])
    with torch.no_grad():
        a = model(x, torch.tensor([0], dtype=torch.int32))
        b = model(x, torch.tensor([40], dtype=torch.int32))
    assert (a - b).abs().max() > 1e-6


def test_init_counts_and_distributions():
    cfg = td.config("unet-tiny", base_channels=32)
    a = td.init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = td.init(cfg, torch.Generator().manual_seed(0), "cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), name
    conv = a.down[1].blocks[0].conv1  # [3, 3, 32, 64]: std 1/sqrt(288)
    assert float(conv.std()) == pytest.approx(288 ** -0.5, rel=0.05)
    assert float(a.mid_attn.wo.std()) == pytest.approx(
        1e-2 / 64 ** 0.5, rel=0.1)
    assert torch.all(a.gn_out_scale == 1) and torch.all(a.conv_out_b == 0)


@pytest.mark.parametrize("preset", ["dp_rules", "fsdp_rules", "tp_fsdp_rules",
                                    "context_parallel_rules"])
def test_param_specs_equal_jax(preset):
    port = td.param_specs(td.config("sd-base"), getattr(tsharding, preset)())
    ref = jd.param_specs(jd.config("sd-base"), getattr(jsharding, preset)())
    assert_specs_match(port, ref)
    rules = getattr(tsharding, preset)()
    assert tuple(td.batch_spec(rules)) == tuple(
        jd.batch_spec(getattr(jsharding, preset)()))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = td.config(PRESET)
    for build in (lambda: td.UNet(cfg),
                  lambda: td.init(cfg, torch.Generator()),
                  lambda: td.from_jax_params(jax_params(jd, PRESET), cfg),
                  lambda: td.make_schedule(cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert td.UNet(cfg, device="cpu").conv_in.device.type == "cpu"


def test_placing_on_a_mesh_waits_for_item_13():
    # A mesh is placed on (ROADMAP item 13 is done); one that is not
    # build_mesh's raises.
    with pytest.raises(ValueError, match="build_mesh"):
        td.init(td.config(PRESET), torch.Generator(), "cpu", mesh=object())

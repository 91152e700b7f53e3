"""The port's T5 against ``ray_tpu.models.t5`` with carried-over weights.

Parameters are drawn with numpy from a seed into the JAX package's
parameter tree, every leaf random (``tests/_torch_zoo.py``), and carried
into the port by ``from_jax_params``; encoder and decoder tokens are made
with numpy from a fixed seed. The JAX side runs under "highest" matmul
precision, so both sides sum the same fp32 products, in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import t5 as jt
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import t5 as tt
from ray_tpu_torch.parallel import sharding as tsharding

from _torch_zoo import (assert_adam_steps_match, assert_grads_match,
                        assert_round_trip, assert_specs_match, jax_params,
                        jax_value_and_grad)

PRESET = "t5-tiny"
# fp32 through 2 + 2 layers and the tied head: summation order only
# (tests/test_torch_gpt.py's bounds).
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
# bf16 on both sides: logits reach |0.26|, where a bf16 ulp is 2^-9; over
# 4 input seeds the gap was 0.0024-0.0037 (2 ulps), as large as each
# package's own bf16 from its fp32 (0.0028-0.0050 in JAX). 2^-7 is 4 ulps;
# a wrong bucket, mask or head scale moves logits by O(0.1).
BF16_TOL = 2.0 ** -7
COUNTS = {"t5-base": 222_903_552}
# ``loss_fn`` over a batch (encoder tokens, decoder tokens, targets, mask);
# remat changes no value, and an all-ones mask is the default's.
_VALUE_AND_GRAD = jax_value_and_grad(
    lambda p, batch: jt.loss_fn(p, jt.config(PRESET), *batch))


def _tokens(B=2, Se=24, Sd=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, Se)).astype(np.int32),
            rng.integers(0, 256, (B, Sd)).astype(np.int32))


def _model(cfg=None, params=None):
    return tt.from_jax_params(params or jax_params(jt, PRESET),
                              cfg or tt.config(PRESET), "cpu")


def _t(a):
    return torch.from_numpy(a).long()


def test_from_jax_params_round_trip_is_exact():
    model = _model()
    assert_round_trip(jax_params(jt, PRESET), model)
    groups = tt.leaf_groups(model)
    assert groups["encoder.attn.wq"] == ["encoder.0.attn.wq",
                                         "encoder.1.attn.wq"]
    assert groups["decoder.cross.wo"] == ["decoder.0.cross.wo",
                                          "decoder.1.cross.wo"]
    assert groups["enc_rel_bias"] == ["enc_rel_bias"]


def test_from_jax_params_rejects_wrong_shapes():
    with pytest.raises(ValueError, match="does not match"):
        tt.from_jax_params(jax_params(jt, PRESET),
                           tt.config(PRESET, rel_pos_buckets=16), "cpu")


@pytest.mark.parametrize("preset", sorted(jt.PRESETS))
def test_config_counts_match_jax(preset):
    jcfg, tcfg = jt.config(preset), tt.config(preset)
    assert tcfg.num_params() == jcfg.num_params()
    for field in ("head_dim", "remat", "layernorm_eps", "rel_pos_buckets",
                  "rel_pos_max_distance"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert tcfg.dtype == getattr(torch, np.dtype(jcfg.dtype).name)
    count = sum(p.numel() for p in tt.T5(tcfg, "meta").parameters())
    assert count == tcfg.num_params() == COUNTS.get(preset, count)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,max_distance", [(8, 32), (32, 128)])
def test_relative_buckets_equal_jax(buckets, max_distance, bidirectional):
    """Every relative position in -4096..4096, exactly: the large buckets
    truncate an fp32 log, so a changed order of operations can move an
    edge."""
    rel = np.arange(-4096, 4097, dtype=np.int32)
    ref = np.asarray(jt._relative_buckets(jnp.asarray(rel), bidirectional,
                                          buckets, max_distance))
    got = tt._relative_buckets(torch.from_numpy(rel), bidirectional,
                               buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_decoder_rel_bias_covers_past():
    """The mirror of test_models.py's test_t5_decoder_rel_bias_covers_past:
    below the diagonal (the visible past) buckets are nonzero and grow
    with distance."""
    rel = torch.arange(6)[:, None] - torch.arange(6)[None, :]
    b = tt._relative_buckets(rel, False, 8, 32)
    for i in range(1, 6):
        for j in range(i):
            assert b[i, j] > 0, (i, j, b)
    assert b[5, 0] >= b[5, 3] > b[5, 4]


@pytest.mark.parametrize("part", ["encode", "forward"])
def test_forward_matches_jax(part):
    params = jax_params(jt, PRESET)
    enc, dec = _tokens()
    args = (enc,) if part == "encode" else (enc, dec)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(getattr(jt, part), static_argnums=1)(
            params, jt.config(PRESET), *args))
    with torch.no_grad():
        got = getattr(tt, part)(_model(), *map(_t, args))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def _loss_batch(seed, masked=True):
    """A copy task: (encoder tokens, decoder inputs shifted right, targets,
    a mask over 70% of the targets, or all of them)."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(2, 40, (4, 8)).astype(np.int32)
    dec_in = np.concatenate([np.zeros((4, 1), np.int32), seq[:, :-1]], 1)
    mask = (rng.random(seq.shape) < 0.7).astype(np.float32) if masked \
        else np.ones(seq.shape, np.float32)
    return seq, dec_in, seq, mask


def _port_loss(model, batch, masked=True):
    enc, dec, targets, mask = batch
    return tt.loss_fn(model, _t(enc), _t(dec), _t(targets),
                      torch.from_numpy(mask) if masked else None)


@pytest.mark.parametrize("remat,masked", [(False, True), (True, False)])
def test_loss_and_gradients_match_jax(remat, masked):
    batch = _loss_batch(1, masked)
    (ref_loss, ref_m), ref_g = _VALUE_AND_GRAD(jax_params(jt, PRESET), batch)
    model = _model(tt.config(PRESET, remat=remat))
    loss, metrics = _port_loss(model, batch, masked)
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
                            jax_params(jt, PRESET), _model(),
                            [_loss_batch(3 + i) for i in range(3)])


def test_bf16_forward_matches_jax():
    params = jax_params(jt, PRESET)
    enc, dec = _tokens(seed=4)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jt.forward, static_argnums=1)(
            params, jt.config(PRESET, dtype=jnp.bfloat16), enc, dec
        ).astype(jnp.float32))
    model = _model(tt.config(PRESET, dtype=torch.bfloat16), params)
    dtypes = []
    for block in list(model.encoder) + list(model.decoder):
        block.register_forward_hook(
            lambda mod, args, out: dtypes.append((args[0].dtype, out.dtype)))
    with torch.no_grad():
        got = tt.forward(model, _t(enc), _t(dec))
    assert dtypes == [(torch.bfloat16, torch.bfloat16)] * 4
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=BF16_TOL,
                               rtol=0)


def test_gradients_after_an_inference_forward_of_the_same_lengths():
    """The cached bucket tables are plain tensors: a forward under
    inference_mode, then one that records gradients, at the same lengths."""
    model = _model()
    enc, dec = map(_t, _tokens(Se=20, Sd=9, seed=5))
    with torch.inference_mode():
        ref = tt.forward(model, enc, dec)
    out = tt.forward(model, enc, dec)
    out.sum().backward()
    torch.testing.assert_close(out.detach(), ref, atol=0, rtol=0)
    assert model.enc_rel_bias.grad is not None


def test_decoder_causality():
    """The mirror of test_models.py's test_t5_decoder_causality."""
    model = tt.init(tt.config(PRESET), torch.Generator().manual_seed(0),
                    "cpu")
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.integers(0, 256, (1, 16)))
    dec = torch.from_numpy(rng.integers(0, 256, (1, 10)))
    with torch.no_grad():
        base = tt.forward(model, enc, dec)
        dec2 = dec.clone()
        dec2[0, 7] = (dec2[0, 7] + 1) % 256
        out2 = tt.forward(model, enc, dec2)
        enc2 = enc.clone()
        enc2[0, 0] = (enc2[0, 0] + 1) % 256
        out3 = tt.forward(model, enc2, dec)
    torch.testing.assert_close(out2[0, :7], base[0, :7], atol=1e-5, rtol=0)
    assert not torch.allclose(out2[0, 7:], base[0, 7:])
    assert not torch.allclose(out3[0, 0], base[0, 0])


def test_init_distributions():
    cfg = tt.config(PRESET)
    a = tt.init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = tt.init(cfg, torch.Generator().manual_seed(0), "cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert float(a.wte.std()) == pytest.approx(64 ** -0.5, rel=0.05)
    assert torch.all(a.decoder[1].ln3 == 1) and torch.all(a.enc_final_ln == 1)


@pytest.mark.parametrize("preset", ["dp_rules", "fsdp_rules", "tp_fsdp_rules",
                                    "context_parallel_rules"])
def test_param_specs_are_the_jax_specs_without_the_layer_axis(preset):
    port = tt.param_specs(tt.config(PRESET), getattr(tsharding, preset)())
    ref = jt.param_specs(jt.config(PRESET), getattr(jsharding, preset)())
    assert_specs_match(port, ref, stacks=("encoder", "decoder"))
    assert tuple(tt.batch_spec(getattr(tsharding, preset)())) == tuple(
        jt.batch_spec(getattr(jsharding, preset)()))


def test_pipeline_rules_and_a_mesh_wait_for_later_items():
    with pytest.raises(NotImplementedError, match="item 12"):
        tt.param_specs(tt.config(PRESET), tsharding.ShardingRules(
            layers="pp"))
    # A mesh is placed on (ROADMAP item 13 is done), under every rules
    # preset, the sequence over sp too (item 14); one that is not
    # build_mesh's raises.
    with pytest.raises(ValueError, match="build_mesh"):
        tt.init(tt.config(PRESET), torch.Generator(), "cpu", mesh=object())
    with pytest.raises(ValueError, match="build_mesh"):
        tt.init(tt.config(PRESET), torch.Generator(), "cpu",
                mesh=object(), rules=tsharding.context_parallel_rules())


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.config(PRESET)
    for build in (lambda: tt.T5(cfg),
                  lambda: tt.init(cfg, torch.Generator()),
                  lambda: tt.from_jax_params(jax_params(jt, PRESET), cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert tt.T5(cfg, device="cpu").wte.device.type == "cpu"

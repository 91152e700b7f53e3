"""The port's BERT against ``ray_tpu.models.bert`` with carried-over weights.

Parameters are drawn with numpy from a seed into the JAX package's
parameter tree, every leaf random (``tests/_torch_zoo.py``), and carried
into the port by ``from_jax_params``; tokens, segments, padding masks and
masked positions are made with numpy from a fixed seed. The JAX side runs
under "highest" matmul precision, so both sides sum the same fp32
products, in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import bert as jb
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import bert as tb
from ray_tpu_torch.parallel import sharding as tsharding

from _torch_zoo import (assert_adam_steps_match, assert_grads_match,
                        assert_round_trip, assert_specs_match, jax_params,
                        jax_value_and_grad)

PRESET = "bert-tiny"
# fp32 through 2 post-LN layers and the tied head: summation order only
# (tests/test_torch_gpt.py's bounds).
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
# bf16 on both sides: MLM logits reach |1.85|, where a bf16 ulp of the
# last hidden state (the head runs in fp32) is 2^-7; over 4 input seeds
# the gap was 0.016-0.021 (2-3 ulps), as large as each package's own bf16
# from its fp32 (0.016-0.023 in JAX). 2^-4 is 8 ulps; a wrong padding
# bias or LayerNorm order moves logits by O(1).
BF16_TOL = 2.0 ** -4
COUNTS = {"bert-base": 110_104_890}
# ``mlm_loss`` over a batch (tokens, targets, masked positions, padding
# mask); remat changes no value, and an all-ones mask is the default's.
_VALUE_AND_GRAD = jax_value_and_grad(
    lambda p, batch: (jb.mlm_loss(p, jb.config(PRESET), *batch), {}))


def _batch(B=2, S=16, seed=0):
    """(tokens, segment ids, padding mask with row 1 padded from 10)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    segments = (np.arange(S) >= S // 2).astype(np.int32)[None].repeat(B, 0)
    mask = np.ones((B, S), np.int32)
    mask[1, 10:] = 0
    return tokens, segments, mask


def _model(cfg=None, params=None):
    return tb.from_jax_params(params or jax_params(jb, PRESET),
                              cfg or tb.config(PRESET), "cpu")


def _t(a):
    return torch.from_numpy(a).long()


def test_from_jax_params_round_trip_is_exact():
    model = _model()
    assert_round_trip(jax_params(jb, PRESET), model)
    assert tb.leaf_groups(model)["layers.bq"] == ["blocks.0.bq",
                                                  "blocks.1.bq"]


def test_from_jax_params_rejects_wrong_shapes():
    with pytest.raises(ValueError, match="does not match"):
        tb.from_jax_params(jax_params(jb, PRESET),
                           tb.config(PRESET, vocab_size=128), "cpu")


@pytest.mark.parametrize("preset", sorted(jb.PRESETS))
def test_config_counts_match_jax(preset):
    jcfg, tcfg = jb.config(preset), tb.config(preset)
    assert tcfg.num_params() == jcfg.num_params()
    for field in ("head_dim", "remat", "layernorm_eps", "max_seq_len",
                  "n_segments"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert tcfg.dtype == getattr(torch, np.dtype(jcfg.dtype).name)
    count = sum(p.numel() for p in tb.Bert(tcfg, "meta").parameters())
    assert count == tcfg.num_params() == COUNTS.get(preset, count)


@pytest.mark.parametrize("head", ["encode", "mlm_logits", "pooled"])
def test_heads_match_jax(head):
    params = jax_params(jb, PRESET)
    tokens, segments, mask = _batch()
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(getattr(jb, head), static_argnums=1)(
            params, jb.config(PRESET), tokens, segments, mask))
    with torch.no_grad():
        got = getattr(tb, head)(_model(), _t(tokens), _t(segments),
                                _t(mask))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def _mlm_batch(seed, padded=True):
    """(tokens with [MASK] = 103 at the masked positions, targets, masked
    positions, padding mask: row 1 padded from 10 when ``padded``)."""
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, 256, (2, 16)).astype(np.int32)
    positions = (rng.random((2, 16)) < 0.25).astype(np.float32)
    tokens = np.where(positions > 0, 103, targets).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 10:] = 0 if padded else 1
    return tokens, targets, positions, mask


def _port_loss(model, batch, padded=True):
    tokens, targets, positions, mask = batch
    return tb.mlm_loss(model, _t(tokens), _t(targets),
                       torch.from_numpy(positions),
                       _t(mask) if padded else None)


@pytest.mark.parametrize("remat,padded", [(False, True), (True, False)])
def test_mlm_loss_and_gradients_match_jax(remat, padded):
    batch = _mlm_batch(1, padded)
    (ref_loss, _), ref_g = _VALUE_AND_GRAD(jax_params(jb, PRESET), batch)
    model = _model(tb.config(PRESET, remat=remat))
    loss = _port_loss(model, batch, padded)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=LOSS_RTOL)
    assert_grads_match(model, ref_g, GRAD_TOL)


def test_adam_steps_match_optax():
    assert_adam_steps_match(_VALUE_AND_GRAD, _port_loss,
                            jax_params(jb, PRESET), _model(),
                            [_mlm_batch(3 + i) for i in range(3)])


def test_bf16_mlm_logits_match_jax():
    params = jax_params(jb, PRESET)
    tokens, segments, mask = _batch(seed=4)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jb.mlm_logits, static_argnums=1)(
            params, jb.config(PRESET, dtype=jnp.bfloat16), tokens, segments,
            mask))
    model = _model(tb.config(PRESET, dtype=torch.bfloat16), params)
    dtypes = []
    for block in model.blocks:
        block.register_forward_hook(
            lambda mod, args, out: dtypes.append((args[0].dtype, out.dtype)))
    with torch.no_grad():
        got = tb.mlm_logits(model, _t(tokens), _t(segments), _t(mask))
    assert dtypes == [(torch.bfloat16, torch.bfloat16)] * 2
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=BF16_TOL, rtol=0)


def test_bidirectional_and_padding_mask():
    """The mirror of test_models.py's
    test_bert_bidirectional_and_padding_mask."""
    model = tb.init(tb.config(PRESET), torch.Generator().manual_seed(1),
                    "cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 256, (1, 12)))
    with torch.no_grad():
        base = tb.mlm_logits(model, toks)
        toks2 = toks.clone()
        toks2[0, -1] = (toks2[0, -1] + 1) % 256
        assert (tb.mlm_logits(model, toks2)[0, 0] - base[0, 0]).abs().max() \
            > 0
        mask = torch.ones((1, 12), dtype=torch.long)
        mask[0, 8:] = 0
        masked1 = tb.mlm_logits(model, toks, attention_mask=mask)
        toks3 = toks.clone()
        toks3[0, 9] = (toks3[0, 9] + 7) % 256
        masked2 = tb.mlm_logits(model, toks3, attention_mask=mask)
    torch.testing.assert_close(masked1[0, :8], masked2[0, :8], rtol=1e-5,
                               atol=1e-5)
    with torch.no_grad():
        cls = tb.pooled(model, toks)
    assert cls.shape == (1, 64) and bool((cls.abs() <= 1.0).all())


def test_init_distributions():
    cfg = tb.config(PRESET)
    a = tb.init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = tb.init(cfg, torch.Generator().manual_seed(0), "cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert float(a.wte.std()) == pytest.approx(0.02, rel=0.05)
    assert torch.all(a.blocks[0].ln2_s == 1) and torch.all(a.mlm_bias == 0)


@pytest.mark.parametrize("preset", ["dp_rules", "fsdp_rules", "tp_fsdp_rules",
                                    "context_parallel_rules"])
def test_param_specs_are_the_jax_specs_without_the_layer_axis(preset):
    port = tb.param_specs(tb.config(PRESET), getattr(tsharding, preset)())
    ref = jb.param_specs(jb.config(PRESET), getattr(jsharding, preset)())
    assert_specs_match(port, ref, stacks=("layers",))
    assert tuple(tb.batch_spec(getattr(tsharding, preset)())) == tuple(
        jb.batch_spec(getattr(jsharding, preset)()))


def test_pipeline_rules_and_a_mesh_wait_for_later_items():
    with pytest.raises(NotImplementedError, match="item 12"):
        tb.param_specs(tb.config(PRESET), tsharding.ShardingRules(
            layers="pp"))
    # A mesh is placed on (ROADMAP item 13 is done), under every rules
    # preset, the sequence over sp too (item 14); one that is not
    # build_mesh's raises.
    with pytest.raises(ValueError, match="build_mesh"):
        tb.init(tb.config(PRESET), torch.Generator(), "cpu", mesh=object())
    with pytest.raises(ValueError, match="build_mesh"):
        tb.init(tb.config(PRESET), torch.Generator(), "cpu",
                mesh=object(), rules=tsharding.context_parallel_rules())


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tb.config(PRESET)
    for build in (lambda: tb.Bert(cfg),
                  lambda: tb.init(cfg, torch.Generator()),
                  lambda: tb.from_jax_params(jax_params(jb, PRESET), cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert tb.Bert(cfg, device="cpu").wte.device.type == "cpu"

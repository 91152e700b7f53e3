"""The port's GPT against ``ray_tpu.models.gpt`` with carried-over weights.

Parameters come from the JAX package's ``init`` (fp32), go to numpy, and
are carried into the port by ``from_jax_params``; tokens are made with
numpy from a fixed seed. The JAX side runs under "highest" matmul
precision so its fp32 products are full fp32 (its flash kernel runs in
Pallas interpret mode, as tests/test_ops.py runs it).
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import flash_attention as tfa

# fp32 logits through 2-4 layers: the two frameworks sum the same fp32
# products in different orders (and differ by an ulp in sin/cos/pow of
# the rotary angles); 1e-4 is the kernel-path bound of test_ops.py.
LOGIT_TOL = 1e-4

_PARAMS = {}


def _jax_params(preset):
    """Numpy pytree of ray_tpu.models.gpt.init (cached per preset)."""
    if preset not in _PARAMS:
        params = jgpt.init(jgpt.config(preset), jax.random.PRNGKey(0))
        _PARAMS[preset] = jax.tree_util.tree_map(np.asarray, params)
    return _PARAMS[preset]


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


@pytest.mark.parametrize("preset", ["gpt-tiny", "gpt-micro"])
@pytest.mark.parametrize("attn_impl,S", [("dot", 64), ("flash", 256)])
def test_forward_matches_jax(preset, attn_impl, S):
    """Flash at S=256: the JAX side takes its Pallas kernel (not the
    ragged route) and the port its kernel's plain version."""
    params = _jax_params(preset)
    jcfg = jgpt.config(preset, attn_impl=attn_impl)
    tokens = _tokens(jcfg, 2, S)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jgpt.forward, static_argnums=1)(
            params, jcfg, tokens))
    model = tgpt.from_jax_params(
        params, tgpt.config(preset, attn_impl=attn_impl), device="cpu")
    before = tfa.launches
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long())
    assert tfa.launches == before  # CPU: the plain version, no kernel
    assert logits.dtype == torch.float32
    assert logits.shape == ref.shape == (2, S, jcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_forward_with_explicit_positions_matches_jax():
    params = _jax_params("gpt-tiny")
    jcfg = jgpt.config("gpt-tiny")
    tokens = _tokens(jcfg, 2, 32, seed=1)
    positions = np.random.default_rng(2).integers(0, 500, (2, 32),
                                                  dtype=np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jgpt.forward(params, jcfg, tokens, positions))
    model = tgpt.from_jax_params(params, tgpt.config("gpt-tiny"), "cpu")
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long(),
                       torch.from_numpy(positions))
    np.testing.assert_allclose(logits.numpy(), ref, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


@pytest.mark.parametrize("preset", ["gpt-tiny", "gpt-micro"])
def test_from_jax_params_round_trip_is_exact(preset):
    params = _jax_params(preset)
    model = tgpt.from_jax_params(params, tgpt.config(preset), "cpu")
    back = {name: p.detach().numpy()
            for name, p in model.named_parameters(recurse=False)}
    back["layers"] = {
        name: np.stack([dict(b.named_parameters())[name].detach().numpy()
                        for b in model.blocks])
        for name, _ in model.blocks[0].named_parameters()}
    want, got = _flatten(params), _flatten(back)
    assert sorted(want) == sorted(got)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        assert np.array_equal(got[name], arr), name


def test_from_jax_params_rejects_wrong_shapes():
    with pytest.raises(ValueError, match="does not match"):
        tgpt.from_jax_params(_jax_params("gpt-tiny"),
                             tgpt.config("gpt-micro"), "cpu")


@pytest.mark.parametrize("preset", sorted(jgpt.PRESETS))
def test_config_counts_match_jax(preset):
    jcfg, tcfg = jgpt.config(preset), tgpt.config(preset)
    assert tcfg.num_params() == jcfg.num_params()
    assert tgpt.flops_per_token(tcfg) == jgpt.flops_per_token(jcfg)
    assert tcfg.head_dim == jcfg.head_dim
    assert tcfg.dtype == getattr(torch, np.dtype(jcfg.dtype).name)


@pytest.mark.parametrize("preset", ["gpt-tiny", "gpt-micro"])
def test_init_shapes_and_distributions(preset):
    cfg = tgpt.config(preset)
    a = tgpt.init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = tgpt.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for p in a.parameters()) == cfg.num_params()
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), name  # same generator seed, same draws
    ref = _jax_params(preset)
    assert tuple(a.blocks[0].wq.shape) == ref["layers"]["wq"].shape[1:]
    assert torch.all(a.lnf_scale == 1) and torch.all(a.blocks[0].b_in == 0)
    std = float(a.wte.detach().std())
    assert 0.018 < std < 0.022  # N(0, 0.02^2) over vocab*d draws


def test_moe_and_sequence_parallel_attention_wait_for_later_slices():
    with pytest.raises(NotImplementedError, match="MoE"):
        tgpt.GPT(tgpt.config("gpt-moe-tiny"), device="cpu")
    model = tgpt.init(tgpt.config("gpt-tiny", attn_impl="ring"),
                      torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="ring"):
        model(torch.zeros((1, 8), dtype=torch.long))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    cfg = tgpt.config("gpt-tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgpt.init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgpt.from_jax_params(_jax_params("gpt-tiny"), cfg)

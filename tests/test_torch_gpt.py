"""The port's GPT against ``ray_tpu.models.gpt`` with carried-over weights.

Parameters come from the JAX package's ``init`` (fp32), go to numpy, and
are carried into the port by ``from_jax_params``; tokens are made with
numpy from a fixed seed. The JAX side runs under "highest" matmul
precision so its fp32 products are full fp32 (its flash kernel runs in
Pallas interpret mode, as tests/test_ops.py runs it).
"""

import math

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import flash_attention as tfa

# fp32 logits through 2-4 layers: the two frameworks sum the same fp32
# products in different orders (and differ by an ulp in sin/cos/pow of
# the rotary angles); 1e-4 is the kernel-path bound of test_ops.py.
LOGIT_TOL = 1e-4
# loss_fn: the bounds of test_models.py's loss tests (chunked against
# unchunked: loss and accuracy rtol 1e-6, grads 1e-6; selective against
# full remat: grads 1e-5). Here the two packages differ in summation order
# as well as in chunking and remat, so every leaf's grad is held to 1e-5.
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5

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


def _grad_tree(model):
    """The port's grads in the JAX package's parameter layout."""
    grads = {name: p.grad.numpy()
             for name, p in model.named_parameters(recurse=False)}
    grads["layers"] = {
        name: np.stack([dict(b.named_parameters())[name].grad.numpy()
                        for b in model.blocks])
        for name, _ in model.blocks[0].named_parameters()}
    return grads


# (preset, attn_impl, remat, remat_policy, loss_chunk): each value of each
# option at least once; chunk 100 divides neither 2x128 nor 2x256 tokens.
LOSS_CASES = [
    ("gpt-tiny", "dot", False, "full", 0),
    ("gpt-tiny", "flash", True, "full", 64),
    ("gpt-tiny", "flash", True, "selective", 100),
    ("gpt-micro", "dot", True, "selective", 64),
    ("gpt-micro", "flash", True, "full", 100),
    ("gpt-micro", "flash", False, "full", 0),
]


@pytest.mark.parametrize("preset,attn_impl,remat,policy,chunk", LOSS_CASES)
def test_loss_fn_matches_jax(preset, attn_impl, remat, policy, chunk):
    """Loss, accuracy and the grad of every leaf, with a mask and z-loss;
    S=128 (gpt-tiny) and 256 (gpt-micro) take the flash kernel route."""
    params = _jax_params(preset)
    opts = dict(attn_impl=attn_impl, remat=remat, remat_policy=policy,
                loss_chunk=chunk)
    jcfg = jgpt.config(preset, **opts)
    S = jcfg.max_seq_len
    rng = np.random.default_rng(3)
    tokens, targets = (rng.integers(0, jcfg.vocab_size, (2, S),
                                    dtype=np.int32) for _ in range(2))
    mask = rng.integers(0, 2, (2, S)).astype(np.float32)

    def loss(p):
        return jgpt.loss_fn(p, jcfg, tokens, targets, mask, z_loss=1e-4)
    with jax.default_matmul_precision("highest"):
        (ref_loss, ref_m), ref_g = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)

    model = tgpt.from_jax_params(params, tgpt.config(preset, **opts), "cpu")
    got_loss, got_m = tgpt.loss_fn(model, *map(torch.from_numpy,
                                               (tokens, targets, mask)),
                                   z_loss=1e-4)
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(ref_loss),
                               rtol=LOSS_RTOL)
    for key in ("loss", "accuracy", "perplexity"):
        assert got_m[key].shape == () and not got_m[key].requires_grad
        np.testing.assert_allclose(float(got_m[key]), float(ref_m[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    want, got = _flatten(jax.tree_util.tree_map(np.asarray, ref_g)), \
        _flatten(_grad_tree(model))
    assert sorted(want) == sorted(got)
    for name, arr in want.items():
        np.testing.assert_allclose(got[name], arr, atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_loss_fn_without_mask_and_eval_mode_match():
    """No mask means every token counts; under no_grad the chunked head
    and remat are skipped and give the same numbers."""
    cfg = tgpt.config("gpt-tiny", remat=True, loss_chunk=64)
    model = tgpt.init(cfg, torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(4)
    tokens, targets = (torch.from_numpy(rng.integers(0, 256, (2, 64)))
                       for _ in range(2))
    loss, m = tgpt.loss_fn(model, tokens, targets)
    with torch.no_grad():
        loss_ng, m_ng = tgpt.loss_fn(model, tokens, targets,
                                     torch.ones((2, 64)))
    torch.testing.assert_close(loss.detach(), loss_ng, rtol=1e-6, atol=0)
    torch.testing.assert_close(m["accuracy"], m_ng["accuracy"])
    assert float(m["perplexity"]) == pytest.approx(math.exp(float(loss)),
                                                   rel=1e-5)


def test_unknown_remat_policy_raises_the_jax_error():
    model = tgpt.init(tgpt.config("gpt-tiny", remat=True,
                                  remat_policy="Selective"),
                      torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="remat_policy"):
        tgpt.loss_fn(model, tokens, tokens)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _remat_run(policy, monkeypatch):
    """gpt-tiny's grads under a remat policy, the runs of the flash
    forward's plain version (K1's stand-in on the CPU) over forward and
    backward, and the matmuls the backward ran."""
    cfg = tgpt.config("gpt-tiny", attn_impl="flash", remat=True,
                      remat_policy=policy)
    model = tgpt.init(cfg, torch.Generator().manual_seed(0), "cpu")
    runs = []
    forward = tfa._flash_forward_reference

    def counted(*args):
        runs.append(1)
        return forward(*args)
    monkeypatch.setattr(tfa, "_flash_forward_reference", counted)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 128)))
    loss = tgpt.loss_fn(model, tokens, tokens)[0]
    with _CountMatmuls() as mm:
        loss.backward()
    monkeypatch.undo()
    return ({n: p.grad for n, p in model.named_parameters()}, len(runs),
            mm.n)


def test_selective_remat_keeps_the_matmuls_and_skips_the_flash_rerun(
        monkeypatch):
    """Under "selective" a block keeps its six matmul outputs and the
    flash forward's, so its backward runs neither again: one flash forward
    per layer ("full": two), and of matmuls only the two gradient products
    of each of the six per layer and of the head; the grads are those of
    "full"."""
    sel, sel_runs, sel_mm = _remat_run("selective", monkeypatch)
    full, full_runs, full_mm = _remat_run("full", monkeypatch)
    n_layers = tgpt.config("gpt-tiny").n_layers
    assert (sel_runs, full_runs) == (n_layers, 2 * n_layers)
    assert sel_mm == 2 * (6 * n_layers + 1) < full_mm
    for name, g in full.items():
        torch.testing.assert_close(sel[name], g, rtol=1e-6, atol=1e-7,
                                   msg=lambda m: f"{name}: {m}")


def test_leaf_groups_name_each_jax_leaf_and_its_layers():
    cfg = tgpt.config("gpt-tiny")
    model = tgpt.init(cfg, torch.Generator().manual_seed(0), "cpu")
    groups = tgpt.leaf_groups(model)
    assert sorted(_flatten(tgpt.to_jax_params(model))) == sorted(groups)
    assert groups["wte"] == ["wte"]
    assert groups["layers.wq"] == [f"blocks.{i}.wq"
                                   for i in range(cfg.n_layers)]
    assert sorted(n for names in groups.values() for n in names) == \
        sorted(n for n, _ in model.named_parameters())


@pytest.mark.parametrize("preset", ["gpt-tiny", "gpt-micro"])
def test_to_jax_params_inverts_from_jax_params(preset):
    params = _jax_params(preset)
    back = tgpt.to_jax_params(tgpt.from_jax_params(
        params, tgpt.config(preset), "cpu"))
    want, got = _flatten(params), _flatten(back)
    assert sorted(want) == sorted(got)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        assert np.array_equal(got[name], arr), name

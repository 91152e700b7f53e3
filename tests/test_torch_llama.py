"""The port's Llama against ``ray_tpu.models.llama`` with carried-over weights.

Parameters come from the JAX package's ``init`` (fp32), go to numpy, and
are carried into the port by ``from_jax_params``; tokens are made with
numpy from a fixed seed. The JAX side runs under "highest" matmul
precision so its fp32 products are full fp32 (its flash kernel runs in
Pallas interpret mode, as tests/test_ops.py runs it); the port's flash
wrapper runs its kernels' plain versions on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.parallel import train_step as tts

# fp32 logits through 2-4 layers: the two frameworks sum the same fp32
# products in different orders; 1e-4 is the kernel-path bound of
# test_ops.py (and of tests/test_torch_gpt.py).
LOGIT_TOL = 1e-4
# loss_fn: loss, accuracy and perplexity to summation order (rtol 1e-6),
# every leaf's gradient to 1e-5 (tests/test_torch_gpt.py's bounds).
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
# bf16 logits: XLA's bf16 silu rounds differently from torch's (about 40%
# of its outputs differ by one bf16 ulp), and the difference travels
# through the layers; llama-micro's logits reach |1.03|, where a bf16 ulp
# is 2^-7. 2^-5 is 4 ulps there (the largest gap seen was 2^-7); a wrong
# mask, scale or rotary moves logits by O(0.1-1).
BF16_LOGIT_ATOL = 2.0 ** -5
# 3 Adafactor steps: the losses to summation order (rel 1e-5, as
# tests/test_torch_train_step.py), each leaf's parameters to 1e-3 of the
# norm of its change; a wrong gradient or step changes it by O(1).
STEP_RTOL = 1e-5
UPDATE_RTOL = 1e-3

_PARAMS = {}


def _jax_params(preset):
    """Numpy pytree of ray_tpu.models.llama.init (cached per preset)."""
    if preset not in _PARAMS:
        params = jllama.init(jllama.config(preset), jax.random.PRNGKey(0))
        _PARAMS[preset] = jax.tree_util.tree_map(np.asarray, params)
    return _PARAMS[preset]


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


@pytest.mark.parametrize("preset", ["llama-tiny", "llama-micro"])
@pytest.mark.parametrize("attn_impl,S", [("dot", 64), ("flash", 256)])
def test_forward_matches_jax(preset, attn_impl, S):
    """Flash at S=256: the JAX side takes its Pallas kernel (not the
    ragged route) and the port its kernel's plain version."""
    params = _jax_params(preset)
    jcfg = jllama.config(preset, attn_impl=attn_impl)
    tokens = _tokens(jcfg, 2, S)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jllama.forward, static_argnums=1)(
            params, jcfg, tokens))
    model = tllama.from_jax_params(
        params, tllama.config(preset, attn_impl=attn_impl), device="cpu")
    before = tfa.launches
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long())
    assert tfa.launches == before  # CPU: the plain version, no kernel
    assert logits.dtype == torch.float32
    assert logits.shape == ref.shape == (2, S, jcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_forward_with_positions_up_to_8191_matches_jax(theta):
    params = _jax_params("llama-tiny")
    jcfg = jllama.config("llama-tiny", rope_theta=theta)
    tokens = _tokens(jcfg, 2, 32, seed=1)
    positions = np.random.default_rng(2).integers(8192 - 64, 8192, (2, 32),
                                                  dtype=np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jllama.forward(params, jcfg, tokens, positions))
    model = tllama.from_jax_params(
        params, tllama.config("llama-tiny", rope_theta=theta), "cpu")
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long(),
                       torch.from_numpy(positions))
    np.testing.assert_allclose(logits.numpy(), ref, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


@pytest.mark.parametrize("attn_impl,S", [("dot", 64), ("flash", 256)])
def test_bf16_forward_matches_jax(attn_impl, S):
    """llama-micro with a bf16 compute dtype on both sides: every block
    takes and returns the residual stream in bf16, and the logits agree
    to a few bf16 ulps."""
    params = _jax_params("llama-micro")
    jcfg = jllama.config("llama-micro", dtype=jnp.bfloat16,
                         attn_impl=attn_impl)
    tokens = _tokens(jcfg, 2, S, seed=3)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jllama.forward, static_argnums=1)(
            params, jcfg, tokens).astype(jnp.float32))
    model = tllama.from_jax_params(
        params, tllama.config("llama-micro", dtype=torch.bfloat16,
                              attn_impl=attn_impl), "cpu")
    dtypes = []
    for block in model.blocks:
        block.register_forward_hook(
            lambda mod, args, out: dtypes.append((args[0].dtype, out.dtype)))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long())
    assert dtypes == [(torch.bfloat16, torch.bfloat16)] * len(model.blocks)
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(), ref,
                               atol=BF16_LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary_matches_jax_at_rope_theta_500000(dtype):
    """Positions up to 8191, where the fp32 angles reach 8191 rad. The
    frequencies and angles are the same fp32 products on both sides; sin
    and cos of them differ by at most an fp32 ulp, so fp32 outputs agree
    to a few fp32 ulps of |x| <= 5 (1e-6), and bf16 outputs to one bf16
    ulp of the cos/sin cast plus one of the result (2^-7 relative)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 4, 128), dtype=np.float32)
    positions = np.stack([np.arange(8192 - 64, 8192),
                          rng.integers(0, 8192, 64)]).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jllama._rotary(jnp.asarray(x).astype(jdt),
                                    jnp.asarray(positions), 500000.0)
                     .astype(jnp.float32))
    got = tllama._rotary(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(positions), 500000.0)
    assert got.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("preset", ["llama-tiny", "llama-micro"])
def test_from_jax_params_round_trip_is_exact(preset):
    params = _jax_params(preset)
    back = tllama.to_jax_params(tllama.from_jax_params(
        params, tllama.config(preset), "cpu"))
    want, got = _flatten(params), _flatten(back)
    assert sorted(want) == sorted(got)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        assert np.array_equal(got[name], arr), name


def test_from_jax_params_rejects_wrong_shapes():
    with pytest.raises(ValueError, match="does not match"):
        tllama.from_jax_params(_jax_params("llama-tiny"),
                               tllama.config("llama-micro"), "cpu")


@pytest.mark.parametrize("preset", sorted(jllama.PRESETS))
def test_config_counts_match_jax(preset):
    jcfg, tcfg = jllama.config(preset), tllama.config(preset)
    assert tcfg.num_params() == jcfg.num_params()
    assert tllama.flops_per_token(tcfg) == jllama.flops_per_token(jcfg)
    assert (tcfg.head_dim, tcfg.kv_heads) == (jcfg.head_dim, jcfg.kv_heads)
    assert tcfg.rope_theta == jcfg.rope_theta
    assert tcfg.dtype == getattr(torch, np.dtype(jcfg.dtype).name)
    assert (tcfg.remat, tcfg.attn_impl) == (jcfg.remat, jcfg.attn_impl)


@pytest.mark.parametrize("preset", ["llama-tiny", "llama-micro"])
def test_init_counts_shapes_and_distributions(preset):
    cfg = tllama.config(preset)
    a = tllama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = tllama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for p in a.parameters()) == cfg.num_params()
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), name  # same generator seed, same draws
    ref = _jax_params(preset)["layers"]
    block = a.blocks[0]
    assert cfg.kv_heads < cfg.n_heads  # both test presets are GQA
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert tuple(getattr(block, name).shape) == ref[name].shape[1:], name
    assert tuple(block.wk.shape) == (cfg.d_model, cfg.kv_heads,
                                     cfg.head_dim)
    assert torch.all(a.final_norm == 1) and torch.all(block.ffn_norm == 1)
    std = float(a.wte.detach().std())
    assert 0.018 < std < 0.022  # N(0, 0.02^2) over vocab*d draws
    out_std = float(torch.cat([b.wo.detach().flatten()
                               for b in a.blocks]).std())
    assert out_std == pytest.approx(0.02 / math.sqrt(2 * cfg.n_layers),
                                    rel=0.05)


@pytest.mark.parametrize("attn_impl", ["dot", "flash"])
def test_causality(attn_impl):
    """Changing the last token changes no logit before it."""
    cfg = tllama.config("llama-tiny", attn_impl=attn_impl)
    model = tllama.init(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, 128, seed=5)).long()
    toks2 = toks.clone()
    toks2[0, -1] = (toks2[0, -1] + 1) % cfg.vocab_size
    with torch.no_grad():
        a, b = model(toks), model(toks2)
    torch.testing.assert_close(a[0, :-1], b[0, :-1], atol=1e-6, rtol=0)
    assert not torch.equal(a[0, -1], b[0, -1])


# (preset, attn_impl, remat, masked): each value of each option at least
# once; S = max_seq_len (128, 256) takes the flash kernel route.
LOSS_CASES = [
    ("llama-tiny", "dot", False, True),
    ("llama-tiny", "flash", True, False),
    ("llama-micro", "dot", True, True),
    ("llama-micro", "flash", False, True),
    ("llama-micro", "flash", True, True),
]


@pytest.mark.parametrize("preset,attn_impl,remat,masked", LOSS_CASES)
def test_loss_fn_matches_jax(preset, attn_impl, remat, masked):
    """Loss, accuracy, perplexity and the grad of every leaf, with z-loss
    and with or without a mask."""
    params = _jax_params(preset)
    opts = dict(attn_impl=attn_impl, remat=remat)
    jcfg = jllama.config(preset, **opts)
    S = jcfg.max_seq_len
    rng = np.random.default_rng(6)
    tokens, targets = (rng.integers(0, jcfg.vocab_size, (2, S),
                                    dtype=np.int32) for _ in range(2))
    mask = rng.integers(0, 2, (2, S)).astype(np.float32) if masked else None

    def loss(p):
        return jllama.loss_fn(p, jcfg, tokens, targets, mask, z_loss=1e-4)
    with jax.default_matmul_precision("highest"):
        (ref_loss, ref_m), ref_g = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)

    model = tllama.from_jax_params(params, tllama.config(preset, **opts),
                                   "cpu")
    got_loss, got_m = tllama.loss_fn(
        model, torch.from_numpy(tokens), torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask), z_loss=1e-4)
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(ref_loss),
                               rtol=LOSS_RTOL)
    for key in ("loss", "accuracy", "perplexity"):
        assert got_m[key].shape == () and not got_m[key].requires_grad
        np.testing.assert_allclose(float(got_m[key]), float(ref_m[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    want = _flatten(jax.tree_util.tree_map(np.asarray, ref_g))
    got = _flatten(tllama.to_jax_params(model))  # names of the JAX leaves
    groups = tllama.leaf_groups(model)
    named = dict(model.named_parameters())
    assert sorted(want) == sorted(got) == sorted(groups)
    for leaf, arr in want.items():
        grad = np.stack([named[n].grad.numpy() for n in groups[leaf]])
        np.testing.assert_allclose(grad.reshape(arr.shape), arr,
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=leaf)


def test_loss_decreases():
    """The port's mirror of test_models.py's test_llama_loss_decreases:
    plain SGD at lr 0.1 on one batch of llama-tiny."""
    cfg = tllama.config("llama-tiny")
    model = tllama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg, 4, 17)).long()
    tokens, targets = toks[:, :-1], toks[:, 1:]
    params = list(model.parameters())
    losses = []
    for _ in range(11):
        loss, _ = tllama.loss_fn(model, tokens, targets)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(0.1 * g)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("attn_impl", ["dot", "flash"])
def test_adafactor_steps_match_jax(attn_impl):
    """3 steps of the port's memory_efficient_optimizer (Adafactor, its
    leaves from leaf_groups) on llama-micro against the JAX package's over
    jax.value_and_grad(llama.loss_fn), from the same weights and batches.
    The schedule starts at 0, so the first step changes no parameter."""
    preset = "llama-micro"
    params0 = _jax_params(preset)
    jcfg = jllama.config(preset, attn_impl=attn_impl)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, jcfg.vocab_size, (2, 129), dtype=np.int32)
               for _ in range(3)]
    jopt = jts.memory_efficient_optimizer(1e-2, warmup_steps=2)

    @jax.jit
    def jstep(params, state, toks):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jllama.loss_fn(p, jcfg, toks[:, :-1], toks[:, 1:]),
            has_aux=True)(params)
        updates, state = jopt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    with jax.default_matmul_precision("highest"):
        params, state = params0, jopt.init(params0)
        ref_losses = []
        for toks in batches:
            params, state, loss = jstep(params, state, toks)
            ref_losses.append(float(loss))
    ref = _flatten(jax.tree_util.tree_map(np.asarray, params))

    model = tllama.from_jax_params(
        params0, tllama.config(preset, attn_impl=attn_impl), "cpu")
    named = dict(model.named_parameters())
    topt = tts.memory_efficient_optimizer(1e-2, warmup_steps=2)
    tstate = topt.init(named, tllama.leaf_groups(model))
    losses = []
    for i, toks in enumerate(map(torch.from_numpy, batches)):
        loss, metrics = tllama.loss_fn(model, toks[:, :-1], toks[:, 1:])
        grads = torch.autograd.grad(loss, list(named.values()))
        with torch.no_grad():
            updates, tstate = topt.update(dict(zip(named, grads)), tstate,
                                          named)
            optim.apply_updates(named, updates)
        losses.append(float(metrics["loss"]))
        if i == 0:
            back = _flatten(tllama.to_jax_params(model))
            assert all(np.array_equal(back[n], a)
                       for n, a in _flatten(params0).items())
    np.testing.assert_allclose(losses, ref_losses, rtol=STEP_RTOL)
    got, p0 = _flatten(tllama.to_jax_params(model)), _flatten(params0)
    for leaf, want in ref.items():
        moved = np.linalg.norm(want - p0[leaf])
        assert moved > 0, leaf
        err = np.linalg.norm(got[leaf] - want) / moved
        assert err <= UPDATE_RTOL, (leaf, err)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tllama.config("llama-tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tllama.Llama(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tllama.init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tllama.from_jax_params(_jax_params("llama-tiny"), cfg)
    assert tllama.Llama(cfg, device="cpu").wte.device.type == "cpu"


@pytest.mark.parametrize("attn_impl", ["ring", "ulysses"])
def test_sequence_parallel_attention_waits_for_a_later_slice(attn_impl):
    model = tllama.init(tllama.config("llama-tiny", attn_impl=attn_impl),
                        torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match=attn_impl):
        model(torch.zeros((1, 8), dtype=torch.long))


def test_leaf_groups_name_each_jax_leaf_and_its_layers():
    cfg = tllama.config("llama-micro")
    model = tllama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    groups = tllama.leaf_groups(model)
    assert sorted(groups) == sorted(_flatten(_jax_params("llama-micro")))
    assert groups["lm_head"] == ["lm_head"]
    assert groups["layers.wk"] == [f"blocks.{i}.wk"
                                   for i in range(cfg.n_layers)]
    assert sorted(n for names in groups.values() for n in names) == \
        sorted(n for n, _ in model.named_parameters())

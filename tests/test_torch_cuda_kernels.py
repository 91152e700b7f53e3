"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips where there
is none. The file imports neither JAX nor ``ray_tpu``, so it runs on a
host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Inputs are made with numpy from a fixed seed.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt, llama
from ray_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# fp32: kernel and plain version sum the same fp32 products in different
# orders (the bound of tests/test_ops.py's kernel path). bf16: both round
# out to bf16 and one bf16 ulp (2^-8 relative) can separate them; lse is
# fp32 from the same bf16 inputs in both.
TOL = {torch.float32: {"out": 1e-4, "lse": 1e-4},
       torch.bfloat16: {"out": 2e-2, "lse": 1e-3}}
# Backward (dq, dk, dv) against the plain version on the same inputs.
# fp32: the bound of tests/test_ops.py's backward tests (atol 2e-3, rtol
# 1e-3; the sums run over up to 4 heads x 256 rows). bf16: both round the
# gradients out to bf16 (2^-8 relative), and the kernels also round p and
# ds to bf16 (2^-9) where they multiply, as K1 rounds p: K1's 2e-2.
BWD_TOL = {torch.float32: (2e-3, 1e-3), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, S, H, KVH, D, dtype, seed, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (B, S, h, D), dtype=np.float32)).to(device, dtype)
        for h in (H, KVH, KVH))


@pytest.mark.parametrize("kv_heads", [8, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_flash_kernel_matches_plain_version(cuda, D, dtype, causal,
                                            kv_heads):
    q, k, v = _qkv(2, 256, 8, kv_heads, D, dtype, seed=D, device=cuda)
    before = fa.launches
    out, lse = fa._flash_forward(q, k, v, causal, 128, 256)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (16, 1, 256)
    ref_out, ref_lse = fa._flash_forward_reference(q, k, v, causal, 128,
                                                   256)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=tol["out"], rtol=tol["out"])
    torch.testing.assert_close(lse, ref_lse, atol=tol["lse"], rtol=1e-4)


def test_flash_kernel_at_the_serving_shape(cuda):
    """gpt-1.3b's attention in one decode step of the serving path."""
    q, k, v = _qkv(4, 1024, 16, 16, 128, torch.bfloat16, seed=0,
                   device=cuda)
    out, lse = fa._flash_forward(q, k, v, True, 512, 512)
    ref_out, ref_lse = fa._flash_forward_reference(q, k, v, True, 512, 512)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def test_flash_kernel_at_the_training_shape(cuda):
    """gpt-1.3b's attention in one training step: B=12, S=1024, 16 heads
    of 128, bf16, causal (48 launches per step under full remat)."""
    q, k, v = _qkv(12, 1024, 16, 16, 128, torch.bfloat16, seed=2,
                   device=cuda)
    out, lse = fa._flash_forward(q, k, v, True, 512, 512)
    ref_out, ref_lse = fa._flash_forward_reference(q, k, v, True, 512, 512)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=tol["out"], rtol=tol["out"])
    torch.testing.assert_close(lse, ref_lse, atol=tol["lse"], rtol=1e-4)


def test_ragged_length_takes_blockwise_route_without_a_launch(cuda):
    q, k, v = _qkv(1, 100, 4, 4, 64, torch.float32, seed=1, device=cuda)
    before = fa.launches
    out, lse = fa._flash_forward(q, k, v, True, 1024, 1024)
    assert lse is None and fa.launches == before
    assert out.shape == q.shape


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(1, 128, 4, 4, 48, torch.float32, seed=2, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa._flash_forward_cuda(q, k, v, True)
    q, k, v = _qkv(1, 128, 4, 4, 64, torch.float32, seed=3, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._flash_forward_cuda(q.half(), k.half(), v.half(), True)
    with pytest.raises(TypeError):
        fa._flash_forward_cuda(q, k.bfloat16(), v, True)
    with pytest.raises(ValueError, match="contiguous"):
        fa._flash_forward_cuda(q.transpose(1, 2).contiguous().transpose(
            1, 2), k, v, True)
    with pytest.raises(ValueError, match="S % 64"):
        fa._flash_forward_cuda(q[:, :96], k[:, :96], v[:, :96], True)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa._flash_forward_cuda(q, k.cpu(), v, True)


def _check_backward(q, k, v, causal, blk_q, blk_k, seed):
    """Run K1, then K2/K3 through the wrapper, against the plain backward
    on the same out, lse and output gradient."""
    out, lse = fa._flash_forward(q, k, v, causal, blk_q, blk_k)
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(q.shape), dtype=np.float32)).to(q.device, q.dtype)
    before = (fa.dq_launches, fa.dkv_launches)
    grads = fa._flash_backward(q, k, v, out, lse, g, causal, blk_q, blk_k)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1,
                                                 before[1] + 1)
    ref = fa._flash_backward_reference(q, k, v, out, lse, g, causal, blk_q,
                                       blk_k)
    atol, rtol = BWD_TOL[q.dtype]
    for name, got, want, like in zip(("dq", "dk", "dv"), grads, ref,
                                     (q, k, v)):
        assert got.dtype == like.dtype and got.shape == like.shape, name
        assert torch.isfinite(got.float()).all(), name
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("kv_heads", [8, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_flash_backward_kernels_match_plain_version(cuda, D, dtype, causal,
                                                    kv_heads):
    q, k, v = _qkv(2, 256, 8, kv_heads, D, dtype, seed=D + 1, device=cuda)
    _check_backward(q, k, v, causal, 128, 256, seed=D + 2)


def test_flash_backward_kernels_at_the_training_shape(cuda):
    """gpt-1.3b's attention in one training step: B=12, S=1024, 16 heads
    of 128, bf16, causal, 512x512 tiles in the plain version."""
    q, k, v = _qkv(12, 1024, 16, 16, 128, torch.bfloat16, seed=4,
                   device=cuda)
    _check_backward(q, k, v, True, 512, 512, seed=5)


def test_flash_attention_backward_launches_k2_and_k3_once(cuda):
    q, k, v = (x.requires_grad_() for x in _qkv(
        2, 256, 8, 2, 64, torch.bfloat16, seed=6, device=cuda))
    out = fa.flash_attention(q, k, v, True, 128, 128)
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (
        before[0], before[1] + 1, before[2] + 1)
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert all(torch.isfinite(x.grad.float()).all() for x in (q, k, v))


def test_ragged_backward_differentiates_blockwise_without_a_launch(cuda):
    q, k, v = (x.requires_grad_() for x in _qkv(
        1, 100, 4, 2, 64, torch.float32, seed=7, device=cuda))
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    fa.flash_attention(q, k, v, True).sum().backward()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before
    assert k.grad.shape == k.shape


def test_flash_backward_rejects_what_the_kernels_do_not_take(cuda):
    q, k, v = _qkv(1, 128, 4, 4, 48, torch.float32, seed=8, device=cuda)
    lse = torch.zeros((4, 1, 128), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa._flash_backward_cuda(q, k, v, q, lse, q, True)
    q, k, v = _qkv(1, 128, 4, 4, 64, torch.float32, seed=9, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._flash_backward_cuda(q.half(), k.half(), v.half(), q.half(), lse,
                                q.half(), True)
    with pytest.raises(ValueError, match="contiguous"):
        fa._flash_backward_cuda(q, k, v, q.transpose(1, 2).contiguous()
                                .transpose(1, 2), lse, q, True)
    with pytest.raises(ValueError, match="must match q"):
        fa._flash_backward_cuda(q, k, v, q, lse, q[:, :, :2].contiguous(),
                                True)
    with pytest.raises(ValueError, match="S % 64"):
        fa._flash_backward_cuda(q[:, :96], k[:, :96], v[:, :96], q[:, :96],
                                lse, q[:, :96], True)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa._flash_backward_cuda(q, k, v, q, lse.cpu(), q, True)


def _remat_grads(policy, device):
    cfg = gpt.config("gpt-tiny", attn_impl="flash", remat=True,
                     remat_policy=policy)
    model = gpt.init(cfg, torch.Generator().manual_seed(0), "cpu")
    card = gpt.GPT(cfg, device=device)
    card.load_state_dict(model.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 128))).to(device)
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    gpt.loss_fn(card, tokens, tokens)[0].backward()
    torch.cuda.synchronize()
    after = (fa.launches, fa.dq_launches, fa.dkv_launches)
    return ({n: p.grad for n, p in card.named_parameters()},
            tuple(b - a for a, b in zip(before, after)), cfg.n_layers)


def test_selective_remat_launches_k1_once_per_layer(cuda):
    """Selective remat keeps K1's out and lse, so its backward launches no
    K1; full remat launches it again in every layer's recompute. The
    gradients agree (fp32: the same kernels on the same inputs)."""
    sel, sel_n, L = _remat_grads("selective", cuda)
    full, full_n, _ = _remat_grads("full", cuda)
    assert sel_n == (L, L, L) and full_n == (2 * L, L, L)
    for name, g in full.items():
        torch.testing.assert_close(sel[name], g, atol=1e-6, rtol=1e-5,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_at_large_logits(cuda, causal):
    """q times 8 (exact in bf16): logits of standard deviation 8, so the
    running max of most rows rises from key tile to key tile and the
    online rescale of o and l runs across tiles."""
    q, k, v = _qkv(2, 1024, 8, 8, 128, torch.bfloat16, seed=11, device=cuda)
    q = q * 8
    out, lse = fa._flash_forward(q, k, v, causal, 512, 512)
    ref_out, ref_lse = fa._flash_forward_reference(q, k, v, causal, 512,
                                                   512)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=tol["out"], rtol=tol["out"])
    torch.testing.assert_close(lse, ref_lse, atol=tol["lse"], rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_with_16_query_heads_over_2_kv_heads(cuda, causal):
    """GQA 16 over 2 at D=128: K1 reads KV head h / 8 through its tensor
    maps, K3 sums 8 query heads into each dk/dv tile."""
    q, k, v = _qkv(2, 512, 16, 2, 128, torch.bfloat16, seed=12, device=cuda)
    out, lse = fa._flash_forward(q, k, v, causal, 256, 256)
    ref_out, ref_lse = fa._flash_forward_reference(q, k, v, causal, 256,
                                                   256)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=tol["out"], rtol=tol["out"])
    torch.testing.assert_close(lse, ref_lse, atol=tol["lse"], rtol=1e-4)
    _check_backward(q, k, v, causal, 256, 256, seed=13)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_flash_kernels_past_the_end_of_the_sequence(cuda, D, causal):
    """S = 192 = 64 x 3: the last 128-row block of the bf16 kernels (K1,
    K2; K3's key blocks) reaches 64 rows past S. Their 4-D tensor maps read
    zeros there (masked as keys in K1; K2's warpgroup of those rows only
    frees its key tiles), and the stores drop those rows and, at the padded
    head dims, the columns past D."""
    q, k, v = _qkv(2, 192, 4, 2, D, torch.bfloat16, seed=D + 14, device=cuda)
    g = torch.from_numpy(np.random.default_rng(D).standard_normal(
        tuple(q.shape), dtype=np.float32)).to(cuda, torch.bfloat16)
    out, lse = fa._flash_forward_cuda(q, k, v, causal)
    ref_out, ref_lse = fa._flash_forward_reference(q, k, v, causal, 64, 64)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=tol["out"], rtol=tol["out"])
    torch.testing.assert_close(lse, ref_lse, atol=tol["lse"], rtol=1e-4)
    grads = fa._flash_backward_cuda(q, k, v, out, lse, g, causal)
    ref = fa._flash_backward_reference(q, k, v, out, lse, g, causal, 64, 64)
    atol, rtol = BWD_TOL[torch.bfloat16]
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol, msg=lambda m: f"{name}: {m}")


def test_flash_bwd_dq_is_deterministic(cuda):
    """K2 sums over the key tiles in registers and writes each dq tile
    once, with no atomics: two runs agree bit for bit."""
    q, k, v = _qkv(2, 512, 8, 2, 128, torch.bfloat16, seed=18, device=cuda)
    g = torch.from_numpy(np.random.default_rng(19).standard_normal(
        tuple(q.shape), dtype=np.float32)).to(cuda, torch.bfloat16)
    out, lse = fa._flash_forward_cuda(q, k, v, True)
    delta = fa._delta(out, g)
    dq0 = fa._flash_bwd_dq_cuda(q, k, v, g, lse, delta, True)
    dq1 = fa._flash_bwd_dq_cuda(q, k, v, g, lse, delta, True)
    assert torch.equal(dq0, dq1)


def test_flash_bwd_dkv_is_deterministic(cuda):
    """K3 sums over the query heads and tiles in registers and writes each
    dk/dv tile once, with no atomics: two runs agree bit for bit."""
    q, k, v = _qkv(2, 512, 8, 2, 128, torch.bfloat16, seed=15, device=cuda)
    g = torch.from_numpy(np.random.default_rng(16).standard_normal(
        tuple(q.shape), dtype=np.float32)).to(cuda, torch.bfloat16)
    out, lse = fa._flash_forward_cuda(q, k, v, True)
    delta = fa._delta(out, g)
    dk0, dv0 = fa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, True)
    dk1, dv1 = fa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, True)
    assert torch.equal(dk0, dk1) and torch.equal(dv0, dv1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_each_wrapper_launches_its_kernel_once(cuda, dtype):
    q, k, v = _qkv(1, 256, 4, 2, 64, dtype, seed=17, device=cuda)
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    out, lse = fa._flash_forward_cuda(q, k, v, True)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (
        before[0] + 1, before[1], before[2])
    delta = fa._delta(out, q)
    fa._flash_bwd_dq_cuda(q, k, v, q, lse, delta, True)
    assert (fa.dq_launches, fa.dkv_launches) == (before[1] + 1, before[2])
    fa._flash_bwd_dkv_cuda(q, k, v, q, lse, delta, True)
    torch.cuda.synchronize()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)


def _check_forward(q, k, v, causal, blk_q, blk_k):
    """K1 through the wrapper against its plain version on the same
    inputs."""
    before = fa.launches
    out, lse = fa._flash_forward(q, k, v, causal, blk_q, blk_k)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref_out, ref_lse = fa._flash_forward_reference(q, k, v, causal, blk_q,
                                                   blk_k)
    tol = TOL[q.dtype]
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=tol["out"], rtol=tol["out"])
    torch.testing.assert_close(lse, ref_lse, atol=tol["lse"], rtol=1e-4)


def test_flash_kernel_at_the_llama3_8b_serving_shape(cuda):
    """llama3-8b's attention in one decode step of the serving path: 32
    query heads over 8 KV heads of 128 (k and v drawn for each head, so a
    wrong KV head shows), bf16, causal, Llama's 1024 x 1024 tiles."""
    q, k, v = _qkv(4, 1024, 32, 8, 128, torch.bfloat16, seed=20,
                   device=cuda)
    _check_forward(q, k, v, True, 1024, 1024)


def test_flash_kernels_at_the_llama3_8b_training_shape(cuda):
    """llama3-8b's attention in one training step: B=1, S=4096, 32 query
    heads over 8 KV heads of 128, bf16, causal; K1, then K2 and K3 (which
    sums the 4 query heads of each KV head)."""
    q, k, v = _qkv(1, 4096, 32, 8, 128, torch.bfloat16, seed=21,
                   device=cuda)
    _check_forward(q, k, v, True, 1024, 1024)
    _check_backward(q, k, v, True, 1024, 1024, seed=22)


def _llama_micro(device):
    """llama-micro (fp32, 8 query heads over 4 KV heads, flash attention)
    on the CPU and the same weights on ``device``, and a batch of tokens."""
    cfg = llama.config("llama-micro", attn_impl="flash")
    cpu = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    card = llama.Llama(cfg, device=device)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab_size, (2, 256)))
    return cfg, cpu, card, tokens


def test_llama_forward_on_the_card_launches_k1_once_per_layer(cuda):
    """The fp32 kernels' GQA path against the plain versions on the CPU, at
    the bound of tests/test_torch_llama.py's fp32 logits."""
    cfg, cpu, card, tokens = _llama_micro(cuda)
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    with torch.inference_mode():
        got = card(tokens.to(cuda))
        torch.cuda.synchronize()
        ref = cpu(tokens)
    assert (fa.launches - before[0], fa.dq_launches - before[1],
            fa.dkv_launches - before[2]) == (cfg.n_layers, 0, 0)
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)


def test_llama_micro_backward_on_the_card_matches_the_cpu(cuda):
    """loss_fn's gradients through K1-K3 on the card (once per layer each)
    against the plain route on the CPU: each tensor's difference within
    1e-4 of its norm (fp32 sums in different orders)."""
    cfg, cpu, card, tokens = _llama_micro(cuda)
    llama.loss_fn(cpu, tokens, tokens)[0].backward()
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    llama.loss_fn(card, tokens.to(cuda), tokens.to(cuda))[0].backward()
    torch.cuda.synchronize()
    assert (fa.launches - before[0], fa.dq_launches - before[1],
            fa.dkv_launches - before[2]) == (cfg.n_layers,) * 3
    for (name, p), (_, ref) in zip(card.named_parameters(),
                                   cpu.named_parameters()):
        err = float((p.grad.cpu() - ref.grad).norm() / ref.grad.norm())
        assert err <= 1e-4, (name, err)


@pytest.fixture
def nccl_mesh(cuda):
    """A 1-rank NCCL process group and the 1-rank mesh over it, as
    ``prepare_mesh`` builds them in a train worker."""
    from ray_tpu_torch.parallel import MeshConfig
    from ray_tpu_torch.train.torch import prepare_mesh
    mesh = prepare_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1, ep=1))
    try:
        yield mesh
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("rules", ["tp_fsdp_rules", "dp_rules"])
def test_gpt_micro_mesh_step_on_the_card_matches_the_step_without(nccl_mesh,
                                                                   rules):
    """gpt-micro (fp32 kernels) through FSDP2 and DTensor on the 1-rank
    mesh against the step without a mesh, from the same seed: 3 AdamW
    steps, losses to fp32 summation order (1e-5) and every parameter to
    tests/test_torch_train_step.py's bounds; one rank runs the same ops,
    so they are expected equal."""
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel import train_step as ts
    cfg = gpt.config("gpt-micro", attn_impl="flash")
    rules = getattr(sharding, rules)()
    plain = ts.init_train_state(
        cfg, optimizer=ts.default_optimizer(1e-3, warmup_steps=1), seed=0)
    placed = ts.init_train_state(
        cfg, nccl_mesh, rules, ts.default_optimizer(1e-3, warmup_steps=1),
        seed=0)
    steps = [ts.make_train_step(cfg, optimizer=ts.default_optimizer(
        1e-3, warmup_steps=1)), ts.make_train_step(
        cfg, nccl_mesh, rules, ts.default_optimizer(1e-3, warmup_steps=1))]
    rng = np.random.default_rng(31)
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (4, 257))).cuda()
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        plain, m_plain = steps[0](plain, batch)
        before = fa.launches, fa.dq_launches, fa.dkv_launches
        placed, m_placed = steps[1](placed, batch)
        torch.cuda.synchronize()
        assert (fa.launches - before[0], fa.dq_launches - before[1],
                fa.dkv_launches - before[2]) == (cfg.n_layers,) * 3
        assert float(m_placed["loss"]) == pytest.approx(
            float(m_plain["loss"]), rel=1e-5)
    for (name, p), (_, ref) in zip(placed["params"].named_parameters(),
                                   plain["params"].named_parameters()):
        torch.testing.assert_close(sharding.local(p), ref, atol=1e-6,
                                   rtol=1e-5, msg=name)


def test_k1_to_k3_through_local_map_on_heads_of_a_dtensor(nccl_mesh):
    """Attention on DTensors sharded over heads runs K1 (forward) and K2/K3
    (backward) on each rank's local heads through ``local_map``; the
    wrapper itself refuses a DTensor."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import local_map
    tp = nccl_mesh["tp"]
    q, k, v = (x.requires_grad_() for x in _qkv(
        2, 256, 8, 2, 64, torch.bfloat16, seed=32, device=nccl_mesh.device_type))
    heads = [Shard(2)]
    attn = local_map(lambda a, b, c: fa.flash_attention(a, b, c, True, 128,
                                                        128),
                     out_placements=heads, in_placements=(heads,) * 3,
                     device_mesh=tp)
    with pytest.raises(TypeError, match="local_map"):
        fa.flash_attention(*(DTensor.from_local(x, tp, heads)
                             for x in (q, k, v)))
    before = fa.launches, fa.dq_launches, fa.dkv_launches
    out = attn(*(DTensor.from_local(x, tp, heads) for x in (q, k, v)))
    assert isinstance(out, DTensor) and tuple(out.placements) == (Shard(2),)
    g = torch.from_numpy(np.random.default_rng(33).standard_normal(
        tuple(out.shape), dtype=np.float32)).to(q.device, q.dtype)
    grads = torch.autograd.grad(out, (q, k, v),
                                DTensor.from_local(g, tp, heads))
    torch.cuda.synchronize()
    assert (fa.launches - before[0], fa.dq_launches - before[1],
            fa.dkv_launches - before[2]) == (1, 1, 1)
    want = fa.flash_attention(q, k, v, True, 128, 128)
    want_grads = torch.autograd.grad(want, (q, k, v), g)
    assert torch.equal(out.to_local(), want)
    for got, ref in zip(grads, want_grads):
        assert torch.equal(got, ref)

"""The port's flash attention (forward and backward) against the JAX
package's.

Inputs are made with numpy from a fixed seed and handed to both packages.
The JAX side runs K1-K3 as tests/test_ops.py runs them on the CPU: the
Pallas kernels in interpret mode under "highest" matmul precision. On the
CPU the port takes its plain versions (``_flash_forward_reference``,
``_flash_backward_reference``); the CUDA kernels themselves are held to
those plain versions on the card by tests/test_torch_cuda_kernels.py.
"""

import math

import jax
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import _flash_backward as jax_flash_backward
from ray_tpu.ops.flash_attention import _flash_forward as jax_flash_forward
from ray_tpu.ops.flash_attention import _pick_block as jax_pick_block
from ray_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ray_tpu_torch.ops import flash_attention as tfa

# The bounds of test_ops.py's kernel-path test (out and lse, fp32): the
# two sides sum the same fp32 products in different orders.
KERNEL_TOL = 1e-4
# The bound of test_ops.py's blockwise tests: same recurrence, fp32.
BLOCKWISE_TOL = 1e-5
# The bound of test_ops.py's backward tests (dq, dk, dv in fp32).
GRAD_ATOL, GRAD_RTOL = 2e-3, 1e-3


def _qkv(B, S, H, KVH, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), dtype=np.float32),
            rng.standard_normal((B, S, KVH, D), dtype=np.float32),
            rng.standard_normal((B, S, KVH, D), dtype=np.float32))


def _jax_forward(q, k, v, causal, blk_q, blk_k):
    with jax.default_matmul_precision("highest"):
        out, lse = jax_flash_forward(jax.numpy.asarray(q),
                                     jax.numpy.asarray(k),
                                     jax.numpy.asarray(v), causal,
                                     blk_q, blk_k)
        return np.asarray(out), None if lse is None else np.asarray(lse)


def _torch_forward(q, k, v, causal, blk_q, blk_k):
    with torch.no_grad():
        out, lse = tfa._flash_forward(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal,
                                      blk_q, blk_k)
    return out.numpy(), None if lse is None else lse.numpy()


CASES = {  # name -> (causal, H, KVH)
    "causal": (True, 4, 4),
    "non_causal": (False, 4, 4),
    "gqa_8_over_2": (True, 8, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("blk", [(128, 128), (128, 256)])
def test_flash_forward_matches_jax_kernel(case, D, blk):
    causal, H, KVH = CASES[case]
    q, k, v = _qkv(2, 256, H, KVH, D, seed=D + H)
    ref_out, ref_lse = _jax_forward(q, k, v, causal, *blk)
    out, lse = _torch_forward(q, k, v, causal, *blk)
    assert ref_lse is not None and lse is not None, "kernel path not taken"
    assert out.shape == ref_out.shape == (2, 256, H, D)
    assert lse.shape == ref_lse.shape == (2 * H, 1, 256)
    assert lse.dtype == np.float32
    np.testing.assert_allclose(out, ref_out, atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
    np.testing.assert_allclose(lse, ref_lse, atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_route_matches_jax(causal):
    """S=100 has no 128-multiple divisor: both packages take blockwise
    attention and return no lse."""
    q, k, v = _qkv(2, 100, 4, 2, 32, seed=3)
    ref_out, ref_lse = _jax_forward(q, k, v, causal, 1024, 1024)
    out, lse = _torch_forward(q, k, v, causal, 1024, 1024)
    assert ref_lse is None and lse is None
    np.testing.assert_allclose(out, ref_out, atol=BLOCKWISE_TOL,
                               rtol=BLOCKWISE_TOL)


def test_pick_block():
    for S, want in [(256, 1024), (1536, 1024), (100, 1024), (1024, 512)]:
        assert tfa._pick_block(S, want) == jax_pick_block(S, want)
    assert tfa._pick_block(256, 1024) == 256
    assert tfa._pick_block(1536, 1024) == 768  # multiple of 128, not 1024
    assert tfa._pick_block(100, 1024) == 0  # ragged → blockwise route


def test_cpu_never_counts_a_launch():
    before = tfa.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 256, 2, 2, 16, seed=0))
    out = tfa.flash_attention(q, k, v, True, 128, 128)
    assert out.shape == (1, 256, 2, 16)
    assert tfa.launches == before


def test_reference_matches_plain_softmax_attention():
    """The tile loop against one dense softmax, including lse: tiles
    smaller than S and blk_q != blk_k exercise the causal cutoff."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 512, 4, 4, 32, seed=2))
    out, lse = tfa._flash_forward_reference(q, k, v, True, 128, 256)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(32)
    mask = torch.ones(512, 512, dtype=torch.bool).tril()
    logits = torch.where(mask, logits, -1e30)
    ref = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v)
    torch.testing.assert_close(out, ref, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    torch.testing.assert_close(lse.reshape(2, 4, 512),
                               logits.logsumexp(-1), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)


def _jnp(*arrays):
    return tuple(jax.numpy.asarray(a) for a in arrays)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("D", [32, 80])
def test_flash_backward_reference_matches_jax_kernels(case, D):
    """K2/K3's plain versions against the Pallas dq and dk/dv kernels, from
    the same out, lse and output gradient."""
    causal, H, KVH = CASES[case]
    q, k, v = _qkv(2, 256, H, KVH, D, seed=D + 7)
    g = np.random.default_rng(D).standard_normal((2, 256, H, D),
                                                 dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        out, lse = jax_flash_forward(*_jnp(q, k, v), causal, 128, 256)
        ref = jax.jit(jax_flash_backward, static_argnums=(6, 7, 8))(
            *_jnp(q, k, v), out, lse, *_jnp(g), causal, 128, 256)
    got = tfa._flash_backward_reference(*_torch(q, k, v, out, lse, g),
                                        causal, 128, 256)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def _jax_grads(q, k, v, causal, blk_q, blk_k):
    def loss(q, k, v):
        return (jax_flash_attention(q, k, v, causal, blk_q, blk_k) ** 2).sum()
    with jax.default_matmul_precision("highest"):
        return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*_jnp(q, k, v))


def _torch_grads(q, k, v, causal, blk_q, blk_k):
    qkv = [x.requires_grad_() for x in _torch(q, k, v)]
    (tfa.flash_attention(*qkv, causal, blk_q, blk_k) ** 2).sum().backward()
    return [x.grad for x in qkv]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("D", [32, 80])
def test_flash_attention_grads_match_jax(case, D):
    """Autograd through FlashAttention (K1, then K2/K3's plain versions)
    against jax.grad through the custom VJP (the Pallas kernels)."""
    causal, H, KVH = CASES[case]
    q, k, v = _qkv(2, 256, H, KVH, D, seed=D + 9)
    ref = _jax_grads(q, k, v, causal, 128, 256)
    got = _torch_grads(q, k, v, causal, 128, 256)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_route_grads_match_jax(causal):
    """S=100: both packages differentiate blockwise attention (GQA 4/2)."""
    q, k, v = _qkv(2, 100, 4, 2, 32, seed=11)
    ref = _jax_grads(q, k, v, causal, 1024, 1024)
    got = _torch_grads(q, k, v, causal, 1024, 1024)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=BLOCKWISE_TOL, rtol=BLOCKWISE_TOL,
                                   err_msg=name)


def test_cpu_backward_never_counts_a_launch():
    before = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    grads = _torch_grads(*_qkv(1, 256, 4, 2, 16, seed=12), True, 128, 128)
    assert [tuple(g.shape) for g in grads] == [(1, 256, 4, 16),
                                               (1, 256, 2, 16),
                                               (1, 256, 2, 16)]
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == before


def test_backward_reference_matches_dense_autograd():
    """The two tile loops against autograd through one dense softmax, with
    tiles smaller than S and blk_q != blk_k (both causal cutoffs)."""
    q, k, v = (x.requires_grad_() for x in _torch(*_qkv(2, 512, 4, 4, 32,
                                                        seed=13)))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(32)
    mask = torch.ones(512, 512, dtype=torch.bool).tril()
    ref_out = torch.einsum("bhqk,bkhd->bqhd",
                           torch.where(mask, logits, -1e30).softmax(-1), v)
    g = torch.randn(ref_out.shape, generator=torch.Generator().manual_seed(0))
    ref = torch.autograd.grad(ref_out, (q, k, v), g)
    with torch.no_grad():
        out, lse = tfa._flash_forward_reference(q, k, v, True, 256, 128)
        got = tfa._flash_backward_reference(q, k, v, out, lse, g, True, 256,
                                            128)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=KERNEL_TOL, rtol=KERNEL_TOL)

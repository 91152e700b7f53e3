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

from ray_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# fp32: kernel and plain version sum the same fp32 products in different
# orders (the bound of tests/test_ops.py's kernel path). bf16: both round
# out to bf16 and one bf16 ulp (2^-8 relative) can separate them; lse is
# fp32 from the same bf16 inputs in both.
TOL = {torch.float32: {"out": 1e-4, "lse": 1e-4},
       torch.bfloat16: {"out": 2e-2, "lse": 1e-3}}


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

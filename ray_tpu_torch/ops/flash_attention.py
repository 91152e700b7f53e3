"""Flash attention forward: a CUDA kernel for Hopper and its plain version.

The port of ``ray_tpu/ops/flash_attention.py``'s forward (K1,
``_flash_fwd_kernel``). :func:`_flash_forward` keeps the JAX package's
contract: q ``[B, S, H, D]``, k/v ``[B, S, KVH, D]`` with ``KVH`` dividing
``H`` (GQA), scale 1/√D, an fp32 online softmax with the -1e30 mask fill,
``out`` in the input dtype and ``lse`` fp32 in the layout ``[B·H, 1, S]``.

Dispatch is by tensor device. A CUDA tensor goes to the kernel in
``csrc/flash_fwd.cu`` (built at first use by ``_build``), which launches
or raises; a CPU tensor goes to :func:`_flash_forward_reference`, the
same tiled recurrence in plain PyTorch. A sequence length with no
128-multiple divisor takes the blockwise route and returns no ``lse``,
exactly as the JAX package does.

The backward kernels (K2 ``_flash_bwd_dq_kernel`` and K3
``_flash_bwd_dkv_kernel``) belong to the training slice of the port;
until then :class:`FlashAttention`'s backward raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.blockwise_attention import blockwise_attention

_NEG_INF = -1e30
# Head dims the kernel is instantiated for: every GPT preset and test size.
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_KERNEL_ROWS = 64  # the kernel's Q and KV tile height; S must be a multiple
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches of this process; the wrapper adds one per launch.
launches = 0


def _repeat_heads(k, v, n_heads):
    kvh = k.shape[2]
    if kvh != n_heads:
        rep = n_heads // kvh
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def _to_bh(x):
    B, S, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, S, D)


def _from_bh(x, B, H):
    BH, S, D = x.shape
    return x.reshape(B, H, S, D).transpose(1, 2)


def _pick_block(S: int, want: int) -> int:
    """Largest 128-aligned block <= want that divides S (0 if none)."""
    b = min(want, S)
    b -= b % 128
    while b >= 128 and S % b:
        b -= 128
    return b


def _flash_forward_reference(q, k, v, causal: bool, blk_q: int, blk_k: int):
    """Plain PyTorch version of K1's recurrence, on any device.

    Loops over Q tiles of ``blk_q`` rows and, inside, over KV tiles of
    ``blk_k`` rows, with an fp32 online softmax: q scaled by 1/√D in fp32,
    masked logits filled with -1e30 and their probabilities zeroed, KV
    tiles past the causal cutoff ``min(cdiv((qi+1)·blk_q, blk_k),
    S/blk_k)`` skipped, ``l`` floored at 1e-30, ``lse = m + log l``."""
    B, S, H, D = q.shape
    k, v = _repeat_heads(k, v, H)
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf = _to_bh(q).float() * scale
    kf, vf = _to_bh(k).float(), _to_bh(v).float()
    BH = B * H
    out = torch.empty((BH, S, D), dtype=q.dtype, device=dev)
    lse = torch.empty((BH, 1, S), dtype=torch.float32, device=dev)
    n_k = S // blk_k
    for qi in range(S // blk_q):
        rows = slice(qi * blk_q, (qi + 1) * blk_q)
        q_pos = torch.arange(rows.start, rows.stop, device=dev)
        m = torch.full((BH, blk_q), _NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((BH, blk_q), dtype=torch.float32, device=dev)
        o = torch.zeros((BH, blk_q, D), dtype=torch.float32, device=dev)
        n_iter = (min(-(-(qi + 1) * blk_q // blk_k), n_k) if causal
                  else n_k)
        for kb in range(n_iter):
            cols = slice(kb * blk_k, (kb + 1) * blk_k)
            logits = qf[:, rows] @ kf[:, cols].transpose(1, 2)
            if causal:
                k_pos = torch.arange(cols.start, cols.stop, device=dev)
                mask = q_pos[:, None] >= k_pos[None, :]
                logits = torch.where(mask, logits, _NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            if causal:
                p = torch.where(mask, p, 0.0)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + p @ vf[:, cols]
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        out[:, rows] = (o / l_safe[..., None]).to(q.dtype)
        lse[:, 0, rows] = m + torch.log(l_safe)
    return _from_bh(out, B, H), lse


def _flash_forward_cuda(q, k, v, causal: bool):
    """Launch K1's CUDA kernel (fp32: FMA; bf16: tensor cores). Tile sizes
    are the kernel's own (64 rows), so the result differs from the plain
    version in summation order and, for bf16, in the bf16 rounding of the
    probabilities that multiply v."""
    global launches
    B, S, H, D = q.shape
    kvh = k.shape[2]
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("flash_attention: q, k and v must be on one CUDA "
                         "device")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.shape != (B, S, kvh, D) or v.shape != k.shape or H % kvh:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head dims "
                         f"{HEAD_DIMS}, got {D}")
    if S % _KERNEL_ROWS:
        raise ValueError(f"flash_attention kernel needs S % "
                         f"{_KERNEL_ROWS} == 0, got S={S}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q/k/v")
    out = torch.empty_like(q)
    lse = torch.empty((B * H, 1, S), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ray_tpu_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, H, kvh, D, _DTYPE_CODES[q.dtype],
            int(causal), ctypes.c_float(1.0 / math.sqrt(D)), stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: "
                           f"{_build.error_string(err)} ({err})")
    launches += 1
    return out, lse


def _flash_forward(q, k, v, causal: bool, blk_q: int, blk_k: int):
    """q: [B, S, H, D], k/v: [B, S, KVH, D] → (out [B, S, H, D], lse
    [B·H, 1, S] fp32, or None on the ragged route)."""
    B, S, H, D = q.shape
    blk_q = _pick_block(S, blk_q)
    blk_k = _pick_block(S, blk_k)
    if blk_q < 128 or blk_k < 128:
        # Ragged sequence (no 128-multiple divisor): the blockwise
        # recurrence, with no lse, as in the JAX package.
        k, v = _repeat_heads(k, v, H)
        return blockwise_attention(q, k, v, causal=causal), None
    if q.device.type == "cuda":
        return _flash_forward_cuda(q, k, v, causal)
    if q.device.type == "cpu":
        return _flash_forward_reference(q, k, v, causal, blk_q, blk_k)
    raise ValueError(f"flash_attention: no path for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Flash attention with the residuals its backward kernels will need."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, blk_q: int = 1024,
                blk_k: int = 1024):
        out, lse = _flash_forward(q, k, v, causal, blk_q, blk_k)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash_attention backward needs the K2/K3 kernels "
            "(_flash_bwd_dq_kernel, _flash_bwd_dkv_kernel), which the "
            "port's training slice brings (ROADMAP.md, queue 1)")


def flash_attention(q, k, v, causal: bool = True, blk_q: int = 1024,
                    blk_k: int = 1024):
    """q: [B, S, H, D], k/v: [B, S, KVH, D] → [B, S, H, D]."""
    return FlashAttention.apply(q, k, v, causal, blk_q, blk_k)

"""Flash attention: CUDA kernels for Hopper and their plain versions.

The port of ``ray_tpu/ops/flash_attention.py``: the forward K1
(``_flash_fwd_kernel``) and the backward K2 (``_flash_bwd_dq_kernel``)
and K3 (``_flash_bwd_dkv_kernel``). :func:`_flash_forward` and
:func:`_flash_backward` keep the JAX package's contract: q ``[B, S, H,
D]``, k/v ``[B, S, KVH, D]`` with ``KVH`` dividing ``H`` (GQA), scale
1/√D, fp32 softmax statistics with the -1e30 mask fill, ``out`` and dq
in q's dtype, dk/dv in k's, and ``lse`` fp32 in the layout ``[B·H, 1,
S]``. ``delta = rowsum(dO∘O)`` of the backward stays a torch op, as it
is a jnp op outside the Pallas kernels in the JAX package.

Dispatch is by tensor device. A CUDA tensor goes to the kernels in
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (built at first use by
``_build``), which launch or raise; a CPU tensor goes to the plain
PyTorch versions (:func:`_flash_forward_reference`,
:func:`_flash_bwd_dq_reference`, :func:`_flash_bwd_dkv_reference`), the
same tiled loops. A sequence length with no 128-multiple divisor takes
the blockwise route and returns no ``lse``, exactly as the JAX package
does; its backward differentiates ``blockwise_attention`` with autograd.

The kernels take plain tensors: a DTensor argument raises ``TypeError``.
On a mesh, attention runs on each rank's local heads, through
``torch.distributed.tensor.experimental.local_map`` or ``to_local``, as
the port's models do.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.blockwise_attention import blockwise_attention

_NEG_INF = -1e30
# Head dims the kernel is instantiated for: every GPT preset and test size.
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
# S must be a multiple of this: the fp32 kernels' tile height; the bf16
# kernels' 128-row blocks read rows past S as zeros and drop their output.
_KERNEL_ROWS = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches of this process; each wrapper adds one per launch of
# its kernel: K1 (forward), K2 (dq) and K3 (dk, dv).
launches = 0
dq_launches = 0
dkv_launches = 0


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


def _check_cuda_inputs(q, k, v, *more):
    """Raise on what the kernels do not take (the wrapper's contract)."""
    B, S, H, D = q.shape
    kvh = k.shape[2]
    if not all(x.is_cuda and x.device == q.device for x in (k, v, *more)):
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
    if not all(x.is_contiguous() for x in (q, k, v, *more)):
        raise ValueError("flash_attention kernel needs contiguous q/k/v")


def _call(fn, device, *args) -> int:
    """Call a C entry with ``args`` and ``device``'s current stream,
    switching the current device only when ``device`` is not it."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, kernel: str) -> None:
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           f"{_build.error_string(err)} ({err})")


def _flash_forward_cuda(q, k, v, causal: bool):
    """Launch K1's CUDA kernel (fp32: FMA; bf16: wgmma fed by TMA). Tile
    sizes are the kernel's own, so the result differs from the plain
    version in summation order and, for bf16, in the bf16 rounding of the
    probabilities that multiply v."""
    global launches
    _check_cuda_inputs(q, k, v)
    B, S, H, D = q.shape
    kvh = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B * H, 1, S), dtype=torch.float32, device=q.device)
    err = _call(_build.load().ray_tpu_flash_fwd, q.device,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, S, H, kvh, D, _DTYPE_CODES[q.dtype],
                int(causal), ctypes.c_float(1.0 / math.sqrt(D)))
    _raise_on(err, "flash_fwd")
    launches += 1
    return out, lse


def _refuse_dtensors(*xs) -> None:
    if any(isinstance(x, DTensor) for x in xs):
        raise TypeError(
            "flash_attention takes plain tensors, got a DTensor: run it on "
            "each rank's local heads through torch.distributed.tensor."
            "experimental.local_map (or to_local/from_local)")


def _flash_forward(q, k, v, causal: bool, blk_q: int, blk_k: int):
    """q: [B, S, H, D], k/v: [B, S, KVH, D] → (out [B, S, H, D], lse
    [B·H, 1, S] fp32, or None on the ragged route)."""
    _refuse_dtensors(q, k, v)
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


def _causal_mask(q_rows: slice, k_rows: slice, device):
    q_pos = torch.arange(q_rows.start, q_rows.stop, device=device)
    k_pos = torch.arange(k_rows.start, k_rows.stop, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def _bwd_inputs(q, k, v, g, lse, delta):
    """fp32 [B·H, S, D] views of the backward's inputs (KV heads repeated),
    q scaled by 1/√D, and lse/delta as [B·H, S]."""
    B, S, H, D = q.shape
    k, v = _repeat_heads(k, v, H)
    qf = _to_bh(q).float() * (1.0 / math.sqrt(D))
    return (qf, _to_bh(k).float(), _to_bh(v).float(), _to_bh(g).float(),
            lse.reshape(B * H, S), delta.reshape(B * H, S))


def _flash_bwd_dq_reference(q, k, v, g, lse, delta, causal: bool,
                            blk_q: int, blk_k: int):
    """Plain PyTorch version of K2: per Q tile of ``blk_q`` rows, over the
    KV tiles of ``blk_k`` rows up to K1's causal cutoff, p = exp(q·scale·kᵀ
    − lse) (masked to 0), ds = p∘(dO·vᵀ − delta), dq += ds·k; dq·scale in
    q's dtype. lse/delta: fp32 ``[B·H, 1, S]``."""
    B, S, H, D = q.shape
    qf, kf, vf, gf, lse, delta = _bwd_inputs(q, k, v, g, lse, delta)
    dq = torch.empty((B * H, S, D), dtype=q.dtype, device=q.device)
    n_k = S // blk_k
    for qi in range(S // blk_q):
        rows = slice(qi * blk_q, (qi + 1) * blk_q)
        acc = torch.zeros((B * H, blk_q, D), dtype=torch.float32,
                          device=q.device)
        n_iter = (min(-(-(qi + 1) * blk_q // blk_k), n_k) if causal
                  else n_k)
        for kb in range(n_iter):
            cols = slice(kb * blk_k, (kb + 1) * blk_k)
            p = torch.exp(qf[:, rows] @ kf[:, cols].transpose(1, 2)
                          - lse[:, rows, None])
            if causal:
                p = torch.where(_causal_mask(rows, cols, q.device), p, 0.0)
            dp = gf[:, rows] @ vf[:, cols].transpose(1, 2)
            acc += (p * (dp - delta[:, rows, None])) @ kf[:, cols]
        dq[:, rows] = (acc * (1.0 / math.sqrt(D))).to(q.dtype)
    return _from_bh(dq, B, H)


def _flash_bwd_dkv_reference(q, k, v, g, lse, delta, causal: bool,
                             blk_q: int, blk_k: int):
    """Plain PyTorch version of K3: per KV tile of ``blk_k`` rows, over the
    Q tiles of ``blk_q`` rows from ``(ki·blk_k)//blk_q`` when causal (0
    when not), dv += pᵀ·dO and dk += dsᵀ·(q·scale). dk/dv are summed over
    the query heads that share a KV head (GQA) in fp32 and returned in
    k's dtype."""
    B, S, H, D = q.shape
    kvh = k.shape[2]
    qf, kf, vf, gf, lse, delta = _bwd_inputs(q, k, v, g, lse, delta)
    dk = torch.empty((B * H, S, D), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    n_q = S // blk_q
    for ki in range(S // blk_k):
        cols = slice(ki * blk_k, (ki + 1) * blk_k)
        acc_k = torch.zeros((B * H, blk_k, D), dtype=torch.float32,
                            device=q.device)
        acc_v = torch.zeros_like(acc_k)
        for qb in range((ki * blk_k) // blk_q if causal else 0, n_q):
            rows = slice(qb * blk_q, (qb + 1) * blk_q)
            p = torch.exp(qf[:, rows] @ kf[:, cols].transpose(1, 2)
                          - lse[:, rows, None])
            if causal:
                p = torch.where(_causal_mask(rows, cols, q.device), p, 0.0)
            acc_v += p.transpose(1, 2) @ gf[:, rows]
            dp = gf[:, rows] @ vf[:, cols].transpose(1, 2)
            ds = p * (dp - delta[:, rows, None])
            acc_k += ds.transpose(1, 2) @ qf[:, rows]
        dk[:, cols], dv[:, cols] = acc_k, acc_v
    rep = H // kvh
    return tuple(_from_bh(x, B, H).reshape(B, S, kvh, rep, D).sum(3)
                 .to(k.dtype) for x in (dk, dv))


def _delta(out, g):
    """rowsum(dO∘O) in fp32, as ``[B·H, 1, S]``."""
    B, S, H, _ = out.shape
    d = (g.float() * out.float()).sum(-1)  # [B, S, H]
    return d.transpose(1, 2).reshape(B * H, 1, S).contiguous()


def _flash_backward_reference(q, k, v, out, lse, g, causal: bool,
                              blk_q: int, blk_k: int):
    """Plain PyTorch version of the whole backward: delta, K2, K3."""
    delta = _delta(out, g)
    dq = _flash_bwd_dq_reference(q, k, v, g, lse, delta, causal, blk_q,
                                 blk_k)
    dk, dv = _flash_bwd_dkv_reference(q, k, v, g, lse, delta, causal,
                                      blk_q, blk_k)
    return dq, dk, dv


def _bwd_launch(kernel: str, q, k, v, g, lse, delta, causal: bool,
                outputs):
    """Launch K2 (``dq``) or K3 (``dkv``) into ``outputs``."""
    B, S, H, D = q.shape
    fn = getattr(_build.load(), f"ray_tpu_flash_bwd_{kernel}")
    err = _call(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                *(x.data_ptr() for x in outputs), B, S, H, k.shape[2], D,
                _DTYPE_CODES[q.dtype], int(causal),
                ctypes.c_float(1.0 / math.sqrt(D)))
    _raise_on(err, f"flash_bwd_{kernel}")


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal: bool):
    """Launch K2 (fp32: FMA; bf16: wgmma fed by TMA) → dq in q's dtype."""
    global dq_launches
    _check_cuda_inputs(q, k, v, g, lse, delta)
    dq = torch.empty_like(q)
    _bwd_launch("dq", q, k, v, g, lse, delta, causal, (dq,))
    dq_launches += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal: bool):
    """Launch K3 (fp32: FMA; bf16: wgmma fed by TMA) → (dk, dv) in k's
    dtype."""
    global dkv_launches
    _check_cuda_inputs(q, k, v, g, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("dkv", q, k, v, g, lse, delta, causal, (dk, dv))
    dkv_launches += 1
    return dk, dv


def _flash_backward_cuda(q, k, v, out, lse, g, causal: bool):
    """delta with torch, then K2 and K3. The kernels' tiles are their own,
    so the result differs from the plain version in summation order and,
    for bf16, in the bf16 rounding of p and ds where they multiply."""
    g = g.contiguous()
    _check_cuda_inputs(q, k, v, out, g, lse)
    if out.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"flash_attention backward: out {tuple(out.shape)} "
                         f"and dO {tuple(g.shape)} must match q "
                         f"{tuple(q.shape)}")
    delta = _delta(out, g)
    dq = _flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal)
    return (dq, *_flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal))


def _flash_backward(q, k, v, out, lse, g, causal: bool, blk_q: int,
                    blk_k: int):
    """Gradients of the kernel route: (dq [B, S, H, D], dk, dv [B, S, KVH,
    D]) from the forward's out and lse and the output gradient g."""
    if q.device.type == "cuda":
        return _flash_backward_cuda(q, k, v, out, lse, g, causal)
    if q.device.type == "cpu":
        return _flash_backward_reference(q, k, v, out, lse, g, causal,
                                         blk_q, blk_k)
    raise ValueError(f"flash_attention: no path for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Flash attention whose backward runs K2 and K3 on the kernel route
    and differentiates the blockwise recurrence on the ragged route.
    ``saved``, the (out, lse) an earlier :func:`_flash_forward` returned
    for these q, k, v, stands in for running the forward again."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, blk_q: int = 1024,
                blk_k: int = 1024, saved=None):
        out, lse = saved or _flash_forward(q, k, v, causal, blk_q, blk_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.blk_q, ctx.blk_k = causal, blk_q, blk_k
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        if lse is None:
            with torch.enable_grad():
                qkv = [x.detach().requires_grad_() for x in (q, k, v)]
                ragged = blockwise_attention(*qkv, causal=ctx.causal)
                grads = torch.autograd.grad(ragged, qkv, grad_out)
        else:
            S = q.shape[1]
            grads = _flash_backward(q, k, v, out, lse, grad_out, ctx.causal,
                                    _pick_block(S, ctx.blk_q),
                                    _pick_block(S, ctx.blk_k))
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, causal: bool = True, blk_q: int = 1024,
                    blk_k: int = 1024, saved=None):
    """q: [B, S, H, D], k/v: [B, S, KVH, D] → [B, S, H, D]; ``saved``: see
    :class:`FlashAttention`. Plain tensors only (a DTensor raises
    ``TypeError``)."""
    _refuse_dtensors(q, k, v)
    return FlashAttention.apply(q, k, v, causal, blk_q, blk_k, saved)

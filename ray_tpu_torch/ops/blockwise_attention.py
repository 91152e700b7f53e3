"""Blockwise (online-softmax) attention in plain PyTorch.

The port of ``ray_tpu/ops/blockwise_attention.py``: iterate over KV
chunks with running (max, sum, out) accumulators in fp32 so the full
[S, S] score matrix never materializes. It is the flash wrapper's route
for sequence lengths with no 128-multiple divisor
(``ops/flash_attention.py``), as in the JAX package.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def _repeat_kv(k, v, n_heads):
    kvh = k.shape[2]
    if kvh != n_heads:
        rep = n_heads // kvh
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def attention_chunk(q, k, v, m, l, o, q_pos, k_pos, causal: bool,
                    scale: float):
    """One online-softmax update. q: [B,H,Sq,D]; k,v: [B,H,Sk,D];
    m,l: [B,H,Sq]; o: [B,H,Sq,D] (fp32 accumulators). Returns updated
    (m, l, o). Products are taken in fp32, as the JAX version's
    ``preferred_element_type=float32``."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(mask, logits, _NEG_INF)
    m_new = torch.maximum(m, logits.amax(-1))
    # Rows with every key masked keep m == _NEG_INF; correction stays finite.
    correction = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    if causal:
        p = torch.where(mask, p, 0.0)
    l_new = l * correction + p.sum(-1)
    o_new = o * correction[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v.float())
    return m_new, l_new, o_new


def blockwise_attention(q, k, v, causal: bool = True,
                        chunk_size: int = 512,
                        q_offset: int = 0, kv_offset: int = 0):
    """Attention over KV chunks. q,k,v: [B, S, H|KVH, D] → [B, S, H, D].
    ``q_offset``/``kv_offset`` shift global positions (for callers whose q
    and kv hold different stretches of the sequence)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    k, v = _repeat_kv(k, v, H)
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    chunk = min(chunk_size, Sk)
    n_chunks = (Sk + chunk - 1) // chunk
    pad = n_chunks * chunk - Sk
    if pad:
        kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
        vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))

    m = torch.full((B, H, Sq), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    far = q_offset + Sq + 10**9  # position past every query: masked
    for idx in range(n_chunks):
        kc = kt[:, :, idx * chunk:(idx + 1) * chunk]
        vc = vt[:, :, idx * chunk:(idx + 1) * chunk]
        # Padded keys sit past the real sequence; mask them via position.
        valid = (idx * chunk + torch.arange(chunk, device=dev)) < Sk
        if causal:
            k_pos = kv_offset + idx * chunk + torch.arange(chunk, device=dev)
            k_pos = torch.where(valid, k_pos, far)
            qp = q_pos
        else:
            # Non-causal: same update, masking only the padding.
            k_pos = torch.where(valid, 0, far)
            qp = torch.full((Sq,), 10**9, device=dev)  # q >= k always
        m, l, o = attention_chunk(qt, kc, vc, m, l, o, qp, k_pos, True,
                                  scale)
    out = o / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)

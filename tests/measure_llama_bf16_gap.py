"""How far llama3-8b's bf16 logits lie from its own fp32 forward, in the
JAX package and in the port, on the CPU: a one-off measurement, not a test.

Both packages take the same weights (``ray_tpu.models.llama.init``,
carried with ``from_jax_params``) and the same tokens, at llama3-8b's
width (d_model 4096, 32 query heads over 8 KV heads of 128, d_ff 14336,
``rope_theta`` 500000) with fewer layers and a cut vocab, and dot
attention. For each package it prints the max and the RMS of
|bf16 - fp32| over its own logits, the largest |logit|, and the max
distance between the two packages' bf16 logits. Run from the repo root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/measure_llama_bf16_gap.py [LAYERS ...]

(default 2 4). One layer's fp32 weights take 0.87 GB in each package.
XLA may skip the bf16 rounding of intermediate values
(``--xla_allow_excess_precision``, on by default); with
``XLA_FLAGS=--xla_allow_excess_precision=false`` the JAX side rounds
every bf16 op as the port does.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama

VOCAB, BATCH, SEQ, SEED = 8192, 2, 512, 0


def _jax_logits(params, cfg, tokens):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jllama.forward(params, cfg, jnp.asarray(tokens)),
                          np.float32)


def _port_logits(params, cfg, tokens):
    model = tllama.from_jax_params(params, cfg, "cpu")
    with torch.no_grad():
        return model(torch.from_numpy(tokens).long()).float().numpy()


def measure(n_layers: int) -> dict:
    over = dict(n_layers=n_layers, vocab_size=VOCAB, attn_impl="dot",
                remat=False)
    jcfg = jllama.config("llama3-8b", **over)
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init(jcfg, jax.random.PRNGKey(SEED)))
    tokens = np.random.default_rng(SEED).integers(
        0, VOCAB, (BATCH, SEQ), dtype=np.int32)
    out = {}
    for name, run, dtypes in (
            ("jax", _jax_logits, (jnp.bfloat16, jnp.float32)),
            ("port", _port_logits, (torch.bfloat16, torch.float32))):
        make = jllama.config if name == "jax" else tllama.config
        bf16, fp32 = (run(params, make("llama3-8b", **over, dtype=dt),
                          tokens) for dt in dtypes)
        gap = np.abs(bf16 - fp32)
        out[name] = {"bf16": bf16, "gap": float(gap.max()),
                     "rms": float(np.sqrt(np.mean(gap ** 2))),
                     "max_logit": float(np.abs(fp32).max())}
    return {"layers": n_layers,
            "jax_gap": out["jax"]["gap"], "port_gap": out["port"]["gap"],
            "jax_rms": out["jax"]["rms"], "port_rms": out["port"]["rms"],
            "max_logit": out["jax"]["max_logit"],
            "port_vs_jax_bf16": float(np.abs(out["port"]["bf16"]
                                             - out["jax"]["bf16"]).max())}


if __name__ == "__main__":
    torch.set_num_threads(4)
    for layers in [int(a) for a in sys.argv[1:]] or [2, 4]:
        print(measure(layers), flush=True)

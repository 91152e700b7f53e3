"""How often gpt-moe-8x410m's bf16 forward routes a token to other experts
than its own fp32 forward, in the JAX package and in the port, on the
CPU: a one-off measurement, not a test.

Both packages take the same weights (``ray_tpu.models.gpt.init``, carried
with ``from_jax_params``) and the same tokens, at gpt-moe-8x410m's width
(d_model 1024, 16 heads of 64, d_ff 4096, 8 experts, top-2, capacity
factor 1.25) with fewer layers and a cut vocab, and dot attention. For
each package and layer it prints the share of tokens whose top-2 experts
differ between the bf16 and the fp32 forward, the share of tokens routed
otherwise in some layer, and the largest |bf16 - fp32| of the logits
beside the largest |logit|. Run from the repo root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/measure_moe_bf16_routing.py [LAYERS ...]

(default 4 8). One layer's fp32 weights take 0.29 GB in each package.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import gpt as tgpt

VOCAB, BATCH, SEQ, SEED = 8192, 2, 512, 0


def _jax_run(params, cfg, tokens):
    """(logits, each layer's top-2 experts [B, S, 2] sorted)."""
    top = []
    with jax.default_matmul_precision("highest"):
        x = jnp.take(params["wte"], tokens, axis=0).astype(cfg.dtype)
        pos = jnp.broadcast_to(jnp.arange(SEQ), (BATCH, SEQ))
        for i in range(cfg.n_layers):
            layer = {k: v[i] for k, v in params["layers"].items()}
            h = jgpt._layernorm(x, layer["ln1_scale"], layer["ln1_bias"],
                                cfg.layernorm_eps)
            probs = jax.nn.softmax(h.astype(jnp.float32)
                                   @ layer["router"].astype(jnp.float32))
            top.append(np.sort(np.asarray(jax.lax.top_k(probs, 2)[1]), -1))
            x, _ = jgpt._block(cfg, x, layer, pos)
        x = jgpt._layernorm(x, params["lnf_scale"], params["lnf_bias"],
                            cfg.layernorm_eps)
        logits = jgpt._head(params, cfg, x)
    return np.asarray(logits, np.float32), top


def _port_run(params, cfg, tokens):
    top, route = [], tgpt._moe_route

    def recording(cfg, h, block):
        out = route(cfg, h, block)
        top.append(out[1].sort(-1).values.numpy())
        return out
    tgpt._moe_route = recording
    try:
        model = tgpt.from_jax_params(params, cfg, "cpu")
        with torch.no_grad():
            logits = model(torch.from_numpy(tokens).long()).float().numpy()
    finally:
        tgpt._moe_route = route
    return logits, top


def measure(n_layers: int) -> dict:
    over = dict(n_layers=n_layers, vocab_size=VOCAB, attn_impl="dot",
                remat=False)
    jcfg = jgpt.config("gpt-moe-8x410m", **over)
    params = jax.tree_util.tree_map(
        np.asarray, jgpt.init(jcfg, jax.random.PRNGKey(SEED)))
    tokens = np.random.default_rng(SEED).integers(
        0, VOCAB, (BATCH, SEQ), dtype=np.int32)
    out = {"layers": n_layers}
    for name, run, make, dtypes in (
            ("jax", _jax_run, jgpt.config, (jnp.bfloat16, jnp.float32)),
            ("port", _port_run, tgpt.config,
             (torch.bfloat16, torch.float32))):
        (bf16, top16), (fp32, top32) = (
            run(params, make("gpt-moe-8x410m", **over, dtype=dt), tokens)
            for dt in dtypes)
        differ = np.stack([(a != b).any(-1) for a, b in zip(top16, top32)])
        out[name] = {"flips_per_layer": differ.mean((1, 2)).round(4).tolist(),
                     "tokens_flipped": float(differ.any(0).mean()),
                     "gap": float(np.abs(bf16 - fp32).max()),
                     "max_logit": float(np.abs(fp32).max())}
    return out


if __name__ == "__main__":
    torch.set_num_threads(4)
    for layers in [int(a) for a in sys.argv[1:]] or [4, 8]:
        print(measure(layers), flush=True)

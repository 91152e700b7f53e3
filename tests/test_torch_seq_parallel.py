"""The port's sequence parallelism against the JAX package's, on gloo ranks.

Ring attention (``ops/ring_attention.py``) on rings of 4 and 8 ranks and
Ulysses (``ops/ulysses.py``) on ``dp=2, sp=4``, whole arrays in and out,
against the JAX package's own on its 8 fake CPU devices
(``tests/test_ops.py:188-222``, ``tests/test_parallel_extra.py:133-156``);
then the train step with the sequence split over ``sp``
(``context_parallel_rules``) under ``attn_impl`` "ring", "ulysses" and
"dot" against the JAX step on the same mesh (``tests/test_ops.py:239``).
The ranks come from ``tests/_torch_ranks.py``'s pools of 8 and 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ranks import RankPool
from ray_tpu.models import gpt as jgpt
from ray_tpu.ops.ring_attention import make_ring_attention
from ray_tpu.ops.ulysses import _full_causal_attention, make_ulysses_attention
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu.parallel import train_step as jts
from test_torch_sharded import (PARAM_ATOL, STEP_RTOL, _check_blocks,
                                _check_plain_forward)

# tests/test_ops.py's ring bounds and tests/test_parallel_extra.py's
# Ulysses bound.
RING_TOL = 1e-5
RING_GRAD_TOL = 1e-4
ULYSSES_TOL = 2e-5


@pytest.fixture(scope="module")
def pools():
    pools = {8: RankPool(8), 4: RankPool(4)}
    yield pools
    for pool in pools.values():
        pool.close()


def _qkv(B, S, H, KVH, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, h, D)).astype(np.float32)
                 for h in (H, KVH, KVH))


RINGS = [
    # (ring size, world, port mesh, B, S, H, KVH, D)
    pytest.param(4, 4, dict(dp=1, fsdp=1, sp=4), 2, 64, 4, 4, 16,
                 id="ring4"),
    pytest.param(4, 8, dict(dp=2, fsdp=1, sp=4), 2, 64, 4, 2, 16,
                 id="ring4-dp2-gqa"),
    pytest.param(8, 8, dict(dp=1, fsdp=1, sp=8), 1, 64, 2, 2, 16,
                 id="ring8"),
]


@pytest.mark.parametrize("n,world,mesh_cfg,B,S,H,KVH,D", RINGS)
def test_ring_attention_matches_jax(pools, n, world, mesh_cfg, B, S, H, KVH,
                                    D):
    q, k, v = _qkv(B, S, H, KVH, D, seed=n)
    cid = pools[world].submit("ring_whole", mesh_cfg, q, k, v)
    mesh = jax.sharding.Mesh(np.array(jax.devices("cpu")[:n]), ("sp",))
    fn = make_ring_attention(mesh, "sp")
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(fn)(q, k, v))
        grads = jax.jit(jax.grad(lambda *x: (fn(*x) ** 2).sum(),
                                 argnums=(0, 1, 2)))(q, k, v)
    for r in pools[world].result(cid):
        np.testing.assert_allclose(r["out"], want, atol=RING_TOL,
                                   rtol=RING_TOL)
        for name, got, g in zip("qkv", r["grads"], grads):
            np.testing.assert_allclose(got, np.asarray(g), atol=RING_GRAD_TOL,
                                       rtol=RING_GRAD_TOL, err_msg=name)


def test_ulysses_matches_jax_and_refuses_indivisible_heads(pools):
    mesh_cfg = dict(dp=2, fsdp=1, tp=1, sp=4, ep=1)
    q, k, v = _qkv(2, 32, 4, 4, 8, seed=0)
    odd = np.zeros((1, 16, 3, 8), np.float32)  # 3 heads over sp=4
    cid = pools[8].submit("ulysses_whole", mesh_cfg, q, k, v, odd)
    mesh = build_mesh(MeshConfig(**mesh_cfg), devices=jax.devices("cpu")[:8])
    attn = make_ulysses_attention(mesh)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(attn)(q, k, v))
        exact = np.asarray(_full_causal_attention(q, k, v))
    np.testing.assert_allclose(want, exact, rtol=ULYSSES_TOL,
                               atol=ULYSSES_TOL)
    with pytest.raises(ValueError):
        attn(odd, odd, odd)
    for r in pools[8].result(cid):
        np.testing.assert_allclose(r["out"], want, rtol=ULYSSES_TOL,
                                   atol=ULYSSES_TOL)
        assert r["error"] and "divisible by sp size 4" in r["error"]


def _world(mesh_cfg) -> int:
    return int(np.prod(list(mesh_cfg.values())))


def _sizes(mesh_cfg):
    cfg = MeshConfig(**mesh_cfg).resolve(_world(mesh_cfg))
    return dict(zip(cfg.axis_names, cfg.shape()))


STEPS = [
    # (mesh, attn_impl): the reference's test_train_step_ring_attention
    # mesh, and one with fsdp and tp under the sequence split.
    pytest.param(dict(dp=2, fsdp=1, tp=1, sp=2), "ring", id="dp2-sp2-ring"),
    pytest.param(dict(dp=2, fsdp=1, tp=1, sp=2), "ulysses",
                 id="dp2-sp2-ulysses"),
    pytest.param(dict(dp=2, fsdp=1, tp=1, sp=2), "dot", id="dp2-sp2-dot"),
    pytest.param(dict(dp=1, fsdp=2, tp=2, sp=2), "ring",
                 id="fsdp2-tp2-sp2-ring"),
]


@pytest.mark.parametrize("mesh_cfg,attn", STEPS)
def test_train_step_with_sequence_parallelism_matches_jax(pools, mesh_cfg,
                                                          attn):
    world = _world(mesh_cfg)
    cfg = jgpt.config("gpt-tiny", attn_impl=attn)
    rules = jsharding.context_parallel_rules()
    mesh = build_mesh(MeshConfig(**mesh_cfg),
                      devices=jax.devices("cpu")[:world])
    jopt = jts.default_optimizer(learning_rate=1e-3, warmup_steps=1)
    tokens = np.random.default_rng(0).integers(0, 256, (4, 64),
                                               dtype=np.int32)
    batches = [{"tokens": tokens, "targets": tokens}] * 2
    with jax.default_matmul_precision("highest"):
        state = jts.init_train_state(cfg, mesh, rules, jopt, seed=0)
        params0 = jax.tree_util.tree_map(np.asarray, state["params"])
        cid = pools[world].submit(
            "gpt_train_step", "gpt-tiny", {"attn_impl": attn}, mesh_cfg,
            "context_parallel_rules", "adamw", params0, batches, 1)
        step = jts.make_train_step(cfg, mesh, rules, jopt)
        ref = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            ref.append({k: float(v) for k, v in m.items()})
        params1 = jax.tree_util.tree_map(np.asarray, state["params"])
    specs, sizes = jgpt.param_specs(cfg, rules), _sizes(mesh_cfg)
    for r in pools[world].result(cid):
        for got, want in zip(r["metrics"], ref):
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=STEP_RTOL), k
        for k, v in r["eval"].items():
            assert np.isfinite(v), k
        _check_blocks(r, params0, specs, sizes, "before")
        _check_plain_forward(r)
        _check_blocks(r, params1, specs, sizes, "after", atol=PARAM_ATOL,
                      rtol=STEP_RTOL)

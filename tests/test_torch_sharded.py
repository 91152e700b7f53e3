"""The port on a mesh of gloo ranks against the JAX package on the same mesh.

The JAX side runs in this process on the 8 fake CPU devices of
``tests/conftest.py``, under "highest" matmul precision. The port's side
runs on spawned gloo ranks (``tests/_torch_ranks.py``: one pool of 8
ranks and one of 4 for the whole module, one thread each), which import
torch only and take the same parameters and batches as numpy arrays. Each
case is sent to the ranks before the JAX side runs, so the two overlap.

Every rank returns its local block of every parameter; the test holds it
to the block that the parameter's JAX ``PartitionSpec`` assigns to the
rank's mesh position (``shard_slices``) of the JAX result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import RankPool
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel.sharding import shard_slices

# One train step's loss and parameters differ from the JAX step's only by
# the frameworks' summation orders (the bounds of
# tests/test_torch_train_step.py).
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-6
# llama-micro's sharded forward: tests/test_models.py's bound.
LLAMA_ATOL = 2e-3
B, S = 8, 128  # S: flash takes its kernel route (a 128-multiple).

OPTIMIZERS = {
    "adamw": lambda m: m.default_optimizer(1e-3, warmup_steps=1),
    "adafactor": lambda m: m.memory_efficient_optimizer(1e-2,
                                                        warmup_steps=1),
}


@pytest.fixture(scope="module")
def pools():
    pools = {8: RankPool(8), 4: RankPool(4)}
    yield pools
    for pool in pools.values():
        pool.close()


def _world(mesh_cfg) -> int:
    return int(np.prod(list(mesh_cfg.values())))


def _jax_mesh(mesh_cfg):
    return build_mesh(MeshConfig(**mesh_cfg),
                      devices=jax.devices("cpu")[:_world(mesh_cfg)])


def _sizes(mesh_cfg):
    cfg = MeshConfig(**mesh_cfg).resolve(_world(mesh_cfg))
    return dict(zip(cfg.axis_names, cfg.shape()))


def _batches(uneven_mask: bool, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        b = {"tokens": rng.integers(0, 512, (B, S), dtype=np.int32),
             "targets": rng.integers(0, 512, (B, S), dtype=np.int32)}
        if uneven_mask:
            # Rows kept from 5% to 95%: every rank holds a different count
            # of tokens, which a mean of per-rank means weighs wrongly.
            keep = np.linspace(0.05, 0.95, B)[:, None]
            b["mask"] = (rng.random((B, S)) < keep).astype(np.float32)
        out.append(b)
    return out


def _port_name_to_jax(name):
    """"blocks.3.wq" → ("layers", "wq", 3); "wte" → ("wte", None, None)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return "layers", parts[2], int(parts[1])
    return name, None, None


def _check_blocks(result, params, specs, sizes, key, **tol):
    """Every rank's local block of every parameter against the block its
    JAX spec gives it of ``params`` (the JAX tree)."""
    for name, got in result[key].items():
        top, leaf, layer = _port_name_to_jax(name)
        if leaf is None:
            whole, spec = params[top], specs[top]
        else:
            whole, spec = params["layers"][leaf][layer], \
                tuple(specs["layers"][leaf])[1:]
        want = whole[shard_slices(whole.shape, spec, sizes,
                                  result["coords"])]
        assert got.shape == want.shape, (name, got.shape, want.shape)
        if tol:
            np.testing.assert_allclose(got, want, err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def _check_plain_forward(result):
    """A forward of an unplaced copy of the model after the steps, on
    every rank and on rank 0 alone, is bit-equal to the one before them:
    the steps leave no mesh or batch layout behind."""
    (logits, aux), after, alone = result["plain"]
    for got in (after,) + ((alone,) if alone is not None else ()):
        np.testing.assert_array_equal(got[0], logits)
        assert got[1] == aux


STEP_CASES = [
    # (mesh, rules, attn_impl, optimizer, accum_steps, uneven mask)
    pytest.param(dict(dp=2, fsdp=2, tp=2), "tp_fsdp_rules", "flash",
                 "adamw", 1, True, id="tp_fsdp-flash-adamw-mask"),
    pytest.param(dict(dp=2, fsdp=2, tp=2), "tp_fsdp_rules", "dot",
                 "adafactor", 1, False, id="tp_fsdp-dot-adafactor"),
    pytest.param(dict(dp=4, fsdp=1), "dp_rules", "dot", "adamw", 1, True,
                 id="dp-dot-adamw-mask"),
    pytest.param(dict(dp=1, fsdp=4), "fsdp_rules", "flash", "adafactor", 2,
                 True, id="fsdp-flash-adafactor-accum2-mask"),
    pytest.param(dict(dp=2, fsdp=2), "fsdp_rules", "dot", "adamw", 1, True,
                 id="hsdp-dot-adamw-mask"),
]


@pytest.mark.parametrize("mesh_cfg,rules_name,attn,opt,accum,uneven",
                         STEP_CASES)
def test_train_step_matches_jax_on_the_same_mesh(pools, mesh_cfg, rules_name,
                                                 attn, opt, accum, uneven):
    cfg = jgpt.config("gpt-micro", attn_impl=attn)
    rules = getattr(jsharding, rules_name)()
    mesh = _jax_mesh(mesh_cfg)
    jopt = OPTIMIZERS[opt](jts)
    batches = _batches(uneven)
    with jax.default_matmul_precision("highest"):
        state = jts.init_train_state(cfg, mesh, rules, jopt, seed=0)
        params0 = jax.tree_util.tree_map(np.asarray, state["params"])
        cid = pools[_world(mesh_cfg)].submit(
            "gpt_train_step", "gpt-micro", {"attn_impl": attn}, mesh_cfg,
            rules_name, opt, params0, batches, accum)
        step = jts.make_train_step(cfg, mesh, rules, jopt,
                                   accum_steps=accum)
        ref = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            ref.append({k: float(v) for k, v in m.items()})
        params1 = jax.tree_util.tree_map(np.asarray, state["params"])
    results = pools[_world(mesh_cfg)].result(cid)

    specs, sizes = jgpt.param_specs(cfg, rules), _sizes(mesh_cfg)
    tcfg = tgpt.config("gpt-micro", attn_impl=attn)
    model = tgpt.from_jax_params(params1, tcfg, "cpu")
    b0 = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    with torch.no_grad():
        _, want_eval = tgpt.loss_fn(model, b0["tokens"], b0["targets"],
                                    b0.get("mask"))
    for r in results:
        assert r["step"] == len(batches)
        for got, want in zip(r["metrics"], ref):
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=STEP_RTOL), k
        for k, v in want_eval.items():
            assert r["eval"][k] == pytest.approx(float(v), rel=STEP_RTOL), k
        _check_blocks(r, params0, specs, sizes, "before")
        _check_plain_forward(r)
        _check_blocks(r, params1, specs, sizes, "after", atol=PARAM_ATOL,
                      rtol=STEP_RTOL)


@pytest.mark.parametrize("world,mesh_cfg,rules_name", [
    (8, dict(dp=2, fsdp=2, tp=2), "tp_fsdp_rules"),
    (4, dict(dp=1, fsdp=4), "fsdp_rules"),
])
def test_init_on_a_mesh_keeps_the_one_device_weights(pools, world, mesh_cfg,
                                                     rules_name):
    """The same seed gives every rank its block of the weights that
    init_train_state draws without a mesh."""
    names = pools[world].run("seeded_init", "gpt-micro", mesh_cfg,
                             rules_name, 3, "memory_efficient_optimizer")
    cfg = tgpt.config("gpt-micro")
    want = [n for n, _ in tgpt.GPT(cfg, "meta").named_parameters()]
    assert all(sorted(n) == sorted(want) for n in names)


def test_build_mesh_lays_ranks_out_row_major(pools):
    out = pools[8].run("mesh_layout", dict(dp=2, fsdp=2, tp=2))
    grid = np.arange(8).reshape(2, 2, 2, 1, 1, 1)
    jgrid = np.vectorize(lambda d: d.id)(
        _jax_mesh(dict(dp=2, fsdp=2, tp=2)).devices)
    for r in out:
        assert np.array_equal(r["grid"], grid)
        assert np.array_equal(r["grid"], jgrid)
        coords = tuple(r["coords"][a] for a in MeshConfig().axis_names)
        assert grid[coords] == r["rank"]


def test_shard_tree_places_the_jax_tree_by_its_specs(pools):
    """The counterpart of the reference's shard_tree: llama-micro's JAX
    tree (layers stacked) placed by its JAX specs; every rank holds the
    block shard_slices gives it."""
    mesh_cfg = dict(dp=2, fsdp=2, tp=2)
    cfg = jllama.config("llama-micro")
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init(cfg, jax.random.PRNGKey(2)))
    specs = jax.tree_util.tree_map(
        tuple, jllama.param_specs(cfg, jsharding.tp_fsdp_rules()),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for r in pools[8].run("tree_blocks", mesh_cfg, params, specs):
        flat = jax.tree_util.tree_leaves_with_path(r["blocks"])
        for path, got in flat:
            keys = [p.key for p in path]
            whole, spec = params, specs
            for k in keys:
                whole, spec = whole[k], spec[k]
            want = whole[shard_slices(whole.shape, spec, _sizes(mesh_cfg),
                                      r["coords"])]
            np.testing.assert_array_equal(got, want, err_msg=str(keys))


@pytest.mark.parametrize("attn", ["dot", "flash"])
def test_llama_sharded_forward_matches_jax(pools, attn):
    """tests/test_models.py's sharded forward, on the port's mesh."""
    mesh_cfg = dict(dp=2, fsdp=2, tp=2)
    cfg = jllama.config("llama-micro", attn_impl=attn)
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init(cfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, S),
                                               dtype=np.int32)
    cid = pools[8].submit("llama_forward", "llama-micro",
                          {"attn_impl": attn}, mesh_cfg, "tp_fsdp_rules",
                          params, tokens.astype(np.int64))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jllama.forward(params, cfg, jnp.asarray(tokens)))
    specs = jllama.param_specs(cfg, jsharding.tp_fsdp_rules())
    for r in pools[8].result(cid):
        np.testing.assert_allclose(r["logits"], want, atol=LLAMA_ATOL)
        _check_blocks(r, params, specs, _sizes(mesh_cfg), "params")

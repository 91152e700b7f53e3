"""The port's sharded checkpoints across gloo ranks: 8 ranks save, 4 resume.

The ranks (``tests/_torch_ranks.py``: a pool of 8 and a pool of 4 for the
module) train gpt-micro under ``tp_fsdp_rules()`` on 8 ranks and save
with ``save_train_state``; the files are read here with the JAX package's
own reader. 4 ranks then resume: under ``fsdp_rules()`` (the specs change,
so ``restore_on_mesh``) and under the saved rules on two meshes of 4
(``load_for_rank``: the same blocks, and fsdp resharded from 2 to 4 with
tp from 2 to 1). Every block a rank holds is the block its spec gives it
of the saved tree, and the next step agrees with the JAX package's step
on 4 fake devices from the same checkpoint (the bounds of
``tests/test_torch_sharded.py``). gpt-moe-tiny's state, its experts split
over ``ep``, is saved by 8 ranks and resumed by 4 alike. Last,
``Checkpoint.from_sharded_state`` (DCP) saves a model placed on one mesh
of 4 and restores it into one placed on another.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import RankPool
from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu.parallel import train_step as jts
from ray_tpu.train._internal import sharded_checkpoint as jsc
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import sharding as tsharding
from test_torch_checkpoint import OPTIMIZERS, _jax_state_on
from test_torch_sharded import PARAM_ATOL, STEP_RTOL, _check_blocks

PRESET = "gpt-micro"
B, S = 8, 64
SAVE_MESH = dict(dp=2, fsdp=2, tp=2)

RESTORES = [
    # (mesh of 4, rules, the route restore_train_state takes)
    pytest.param(dict(dp=1, fsdp=4), "fsdp_rules", "restore_on_mesh",
                 id="fsdp4-fsdp_rules"),
    pytest.param(dict(dp=1, fsdp=2, tp=2), "tp_fsdp_rules", "load_for_rank",
                 id="fsdp2-tp2-saved_rules"),
    pytest.param(dict(dp=1, fsdp=4, tp=1), "tp_fsdp_rules", "load_for_rank",
                 id="fsdp4-tp1-saved_rules"),
]


@pytest.fixture(scope="module")
def pools():
    pools = {8: RankPool(8), 4: RankPool(4)}
    yield pools
    for pool in pools.values():
        pool.close()


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 512, (B, S), dtype=np.int32),
             "targets": rng.integers(0, 512, (B, S), dtype=np.int32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def saved(pools, tmp_path_factory):
    """One 8-rank save per optimizer, made on first use: (the 8 ranks'
    results, the JAX package's handle on the manifest)."""
    done = {}

    def get(opt_name):
        if opt_name not in done:
            storage = str(tmp_path_factory.mktemp(f"ckpt-{opt_name}"))
            results = pools[8].run("ckpt_save", PRESET, SAVE_MESH,
                                   "tp_fsdp_rules", opt_name, storage,
                                   _batches(2))
            done[opt_name] = (results, jsc.ShardedCheckpoint
                              .from_manifest_uri(results[0]["uri"]))
        return done[opt_name]
    return get


def _sizes(mesh_cfg, world):
    cfg = MeshConfig(**mesh_cfg).resolve(world)
    return dict(zip(cfg.axis_names, cfg.shape()))


def _param_specs(rules_name, flat):
    """Each saved parameter leaf's JAX spec under ``rules_name``, normalized,
    by path below "params"."""
    specs = jgpt.param_specs(jgpt.config(PRESET),
                             getattr(jsharding, rules_name)())
    leaves = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, spec in leaves:
        name = "/".join(str(k.key) for k in path)
        out[name] = jsc.normalize_spec(spec, flat["params/" + name].ndim)
    return out


def _expected_spec(path, shape, flat, pspecs):
    """A leaf's spec as the JAX package would shard it: a parameter's by
    the model's specs; a moment's by its parameter's, less the dim a
    factored moment reduces; counts and optax's placeholders replicated."""
    top, _, rest = path.partition("/")
    if top == "params":
        return pspecs[rest]
    param = "/".join(path.split("/")[4:])
    if top == "step" or not param:
        return []
    pshape, pspec = flat["params/" + param].shape, pspecs[param]
    if tuple(shape) == tuple(pshape):
        return pspec
    if tuple(shape) == (1,):
        return [[]]
    drops = [i for i in range(len(pshape))
             if tuple(np.delete(pshape, i)) == tuple(shape)]
    assert len(drops) == 1, (path, shape, pshape)
    return pspec[:drops[0]] + pspec[drops[0] + 1:]


def _assert_blocks(results, whole, specs_of, sizes):
    """Every rank's block of every leaf is its spec's block of ``whole``."""
    for res in results:
        assert set(res["blocks"]) == set(whole)
        for path, got in res["blocks"].items():
            spec = specs_of(path, whole[path].shape)
            want = whole[path][jsc.shard_slices(whole[path].shape, spec,
                                                sizes, res["coords"])]
            assert got.dtype == want.dtype, path
            np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_eight_ranks_save_only_their_blocks(saved, opt_name):
    results, ckpt = saved(opt_name)
    manifest = ckpt.manifest
    sizes = _sizes(SAVE_MESH, 8)
    assert ckpt.world_size == 8 and dict(ckpt.mesh_axes) == sizes
    whole, _ = jsc.flatten_tree(ckpt.load_full())
    pspecs = _param_specs("tp_fsdp_rules", whole)
    for path in whole:
        assert manifest["specs"][path] == _expected_spec(
            path, whole[path].shape, whole, pspecs), path
    total = sum(a.nbytes for a in whole.values())
    for rank, (res, shard) in enumerate(zip(results, manifest["shards"])):
        assert shard["rank"] == rank
        assert res["coords"] == jsc.rank_coords(rank, ckpt.mesh_axes)
        blocks = shard["blocks"]
        assert shard["bytes"] == sum(b["length"] for b in blocks.values())
        assert shard["bytes"] < total
        for path, block in blocks.items():
            sel = jsc.shard_slices(whole[path].shape,
                                   manifest["specs"][path], sizes,
                                   res["coords"])
            # write_shard records a 0-d block as (1,), as
            # np.ascontiguousarray makes it.
            want = np.ascontiguousarray(
                np.empty(tuple(s.stop - s.start for s in sel))).shape
            assert tuple(block["shape"]) == want, path
    _assert_blocks(results, whole,
                   lambda p, shape: manifest["specs"][p], sizes)


@pytest.mark.parametrize("mesh_cfg,rules_name,route", RESTORES)
@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_four_ranks_resume_from_eight(pools, saved, opt_name, mesh_cfg,
                                      rules_name, route):
    _, ckpt = saved(opt_name)
    batch = _batches(1, seed=1)[0]
    cid = pools[4].submit("ckpt_restore", PRESET, mesh_cfg, rules_name,
                          opt_name, ckpt.uri, batch)
    tree = ckpt.load_full()
    whole, _ = jsc.flatten_tree(tree)
    cfg, rules = jgpt.config(PRESET), getattr(jsharding, rules_name)()
    mesh = build_mesh(MeshConfig(**mesh_cfg), devices=jax.devices("cpu")[:4])
    jopt = OPTIMIZERS[opt_name](jts)
    with jax.default_matmul_precision("highest"):
        state = _jax_state_on(mesh, tree, jgpt, cfg, jopt, rules)
        state, m = jts.make_train_step(cfg, mesh, rules, jopt)(state, batch)
        after = jax.tree_util.tree_map(np.asarray, state["params"])
    results = pools[4].result(cid)

    sizes = _sizes(mesh_cfg, 4)
    pspecs = _param_specs(rules_name, whole)
    assert all(r["route"] == route for r in results)
    _assert_blocks(results, whole,
                   lambda p, shape: _expected_spec(p, shape, whole, pspecs),
                   sizes)
    losses = [r["loss"] for r in results]
    np.testing.assert_allclose(losses, float(m["loss"]), rtol=STEP_RTOL)
    assert all(r["step"] == 3 for r in results)
    specs = tgpt.param_specs(tgpt.config(PRESET),
                             getattr(tsharding, rules_name)())
    specs["layers"] = {k: (None,) + tuple(v)
                       for k, v in specs["layers"].items()}
    for res in results:
        _check_blocks(res, after, specs, sizes, "after", atol=PARAM_ATOL,
                      rtol=STEP_RTOL)


def test_dcp_round_trip_on_four_ranks_into_another_layout(pools, tmp_path):
    """DCP saves a model placed by tp_fsdp_rules on fsdp 2 x tp 2 and
    restores it into one of another seed placed by fsdp_rules on fsdp 4:
    every rank's block is the saved model's block under the new specs."""
    results = pools[4].run("dcp_round_trip", PRESET, dict(fsdp=2, tp=2),
                           "tp_fsdp_rules", dict(fsdp=4), "fsdp_rules",
                           str(tmp_path / "dcp"))
    model = tgpt.init(tgpt.config(PRESET), torch.Generator().manual_seed(0),
                      "cpu")
    params = tgpt.to_jax_params(model)
    specs = tgpt.param_specs(tgpt.config(PRESET), tsharding.fsdp_rules())
    specs["layers"] = {k: (None,) + tuple(v)
                       for k, v in specs["layers"].items()}
    for res in results:
        assert res["step"] == 7 and res["extra"] == {"step": 7}
        _check_blocks(res, params, specs, _sizes(dict(fsdp=4), 4), "params")


MOE_PRESET = "gpt-moe-tiny"
MOE_SAVE_MESH = dict(dp=2, fsdp=1, tp=1, sp=1, ep=4)
MOE_RESTORES = [
    # (mesh of 4, rules, the route restore_train_state takes)
    pytest.param(dict(dp=1, fsdp=2, tp=1, sp=1, ep=2), "tp_fsdp_rules",
                 "load_for_rank", id="fsdp2-ep2-saved_rules"),
    pytest.param(dict(dp=1, fsdp=1, tp=1, sp=1, ep=4), "fsdp_rules",
                 "restore_on_mesh", id="ep4-fsdp_rules"),
]


def _moe_batches(n, seed):
    rng = np.random.default_rng(seed)
    vocab = jgpt.config(MOE_PRESET).vocab_size
    return [{"tokens": rng.integers(0, vocab, (B, S), dtype=np.int32),
             "targets": rng.integers(0, vocab, (B, S), dtype=np.int32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def moe_saved(pools, tmp_path_factory):
    """gpt-moe-tiny saved by 8 ranks (experts over ep=4) under
    tp_fsdp_rules with Adafactor, after 2 steps."""
    storage = str(tmp_path_factory.mktemp("moe-ckpt"))
    results = pools[8].run("ckpt_save", MOE_PRESET, MOE_SAVE_MESH,
                           "tp_fsdp_rules", "adafactor", storage,
                           _moe_batches(2, seed=5))
    return results, jsc.ShardedCheckpoint.from_manifest_uri(results[0]["uri"])


def _spec_at(specs, path):
    node = specs
    for key in path.split("/"):
        node = node[key]
    return node


@pytest.mark.parametrize("mesh_cfg,rules_name,route", MOE_RESTORES)
def test_moe_experts_over_ep_saved_by_eight_resume_on_four(
        pools, moe_saved, mesh_cfg, rules_name, route):
    """Each of the 8 ranks saved its own experts' block; 4 ranks resume by
    either route, hold their blocks of the saved parameters, and take the
    JAX package's next step on 4 fake devices."""
    results, ckpt = moe_saved
    whole, _ = jsc.flatten_tree(ckpt.load_full())
    w_in = whole["params/layers/w_in"]
    for r in results:
        block = r["blocks"]["params/layers/w_in"]
        assert block.shape[1] == w_in.shape[1] // MOE_SAVE_MESH["ep"]
    batch = _moe_batches(1, seed=6)[0]
    cid = pools[4].submit("ckpt_restore", MOE_PRESET, mesh_cfg, rules_name,
                          "adafactor", ckpt.uri, batch)
    cfg, rules = jgpt.config(MOE_PRESET), getattr(jsharding, rules_name)()
    mesh = build_mesh(MeshConfig(**mesh_cfg), devices=jax.devices("cpu")[:4])
    jopt = OPTIMIZERS["adafactor"](jts)
    with jax.default_matmul_precision("highest"):
        state = _jax_state_on(mesh, ckpt.load_full(), jgpt, cfg, jopt, rules)
        state, m = jts.make_train_step(cfg, mesh, rules, jopt)(state, batch)
        after = jax.tree_util.tree_map(np.asarray, state["params"])
    sizes = _sizes(mesh_cfg, 4)
    specs = tgpt.param_specs(tgpt.config(MOE_PRESET),
                             getattr(tsharding, rules_name)())
    specs["layers"] = {k: (None,) + tuple(v)
                       for k, v in specs["layers"].items()}
    for r in pools[4].result(cid):
        assert r["route"] == route and r["step"] == 3
        for path, got in r["blocks"].items():
            if path.startswith("params/"):
                spec = jsc.normalize_spec(
                    _spec_at(specs, path[len("params/"):]), got.ndim)
                want = whole[path][jsc.shard_slices(
                    whole[path].shape, spec, sizes, r["coords"])]
                np.testing.assert_array_equal(got, want, err_msg=path)
        assert r["loss"] == pytest.approx(float(m["loss"]), rel=STEP_RTOL)
        _check_blocks(r, after, specs, sizes, "after", atol=PARAM_ATOL,
                      rtol=STEP_RTOL)

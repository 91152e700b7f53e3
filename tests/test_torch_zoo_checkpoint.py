"""Sharded checkpoints of the model zoo's train states, in the JAX package's
format.

(a) 8 gloo ranks train t5-tiny (its two stacks) and vit-tiny on a mesh
with the port's AdamW at weight decay 0 and save with
``save_train_state``; 4 ranks resume by both routes of
``restore_train_state``: under the saved rules on a mesh of 4
(``load_for_rank``, resharding) and under ``fsdp_rules()``
(``restore_on_mesh``). Every block a rank holds is its spec's block of
the saved tree, and the next step agrees with the port's step from the
same tree without a mesh (whose steps (b), (c) and
``tests/test_torch_zoo_mesh.py`` hold to the JAX package's). 4 ranks
train bert-tiny with its sequence over sp (fsdp=2, sp=2 under
``context_parallel_rules()``) and save it, each shard written once
across the sp replicas; 4 ranks on fsdp=4 resume it.

(b) The JAX package trains t5-tiny on 4 fake devices with
``optax.adamw`` and writes the checkpoint with its own writer; the port
restores it, every leaf exactly, and its next step agrees with the JAX
package's. (c) The port saves t5-tiny; the JAX package reads every leaf
exactly and its next step from it agrees with the port's.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JaxSpec

from _torch_ranks import RankPool
from _torch_zoo import jax_params
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.train._internal import sharded_checkpoint as jsc
from ray_tpu_torch._private import spill
from ray_tpu_torch.models import _params
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.train import (CheckpointManager, ShardedCheckpoint,
                                 restore_train_state, save_train_state)
from ray_tpu_torch.train._internal import sharded_checkpoint as sc
from ray_tpu_torch.train.torch.checkpoint import restore_route
from test_torch_checkpoint_ranks import _assert_blocks
from test_torch_zoo_mesh import (LR, MODULES, VIT_TP_RULES, _inputs,
                                 _jax_loss, _jax_rules, _place, _place_batch,
                                 _sizes)

# One step from the same state: the losses and parameters differ only by
# the two frameworks' summation orders (tests/test_torch_sharded.py).
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-6
SAVE_STEPS = 2

SAVES = {  # model: (its module's key, the mesh of 8 and rules it saves on)
    "t5": ("t5", dict(dp=2, fsdp=2, tp=2), "tp_fsdp_rules"),
    "vit": ("vit", dict(dp=4, tp=2), VIT_TP_RULES),
}
RESTORES = [
    # (model, mesh of 4, rules, the route restore_train_state takes)
    pytest.param("t5", dict(fsdp=2, tp=2), "tp_fsdp_rules", "load_for_rank",
                 id="t5-fsdp2-tp2-saved_rules"),
    pytest.param("t5", dict(fsdp=4), "fsdp_rules", "restore_on_mesh",
                 id="t5-fsdp4-fsdp_rules"),
    pytest.param("vit", dict(dp=2, tp=2), VIT_TP_RULES, "load_for_rank",
                 id="vit-dp2-tp2-saved_rules"),
    pytest.param("vit", dict(fsdp=4), "fsdp_rules", "restore_on_mesh",
                 id="vit-fsdp4-fsdp_rules"),
]


@pytest.fixture(scope="module")
def pools():
    pools = {8: RankPool(8), 4: RankPool(4)}
    yield pools
    for pool in pools.values():
        pool.close()


def _batches(name, n, seed):
    return [_inputs(name, seed + i, 8)[1] for i in range(n)]


def _jax_adamw():
    """The port's ``optim.adamw`` at weight decay 0 on a constant rate, in
    optax's terms (a schedule, so that its state keeps a count as the
    port's does)."""
    return optax.adamw(optax.constant_schedule(LR), weight_decay=0.0)


def _jax_state_on(mesh, tree, jmod, cfg, rules):
    """A JAX train state from a checkpoint's tree: parameters placed by
    the model's specs, optax's state rebuilt from the tree's leaves (in
    the same order), replicated."""
    params = _place(mesh, tree["params"], jmod.param_specs(cfg, rules))
    rep = NamedSharding(mesh, JaxSpec())
    treedef = jax.tree_util.tree_structure(_jax_adamw().init(params))
    opt_state = jax.tree_util.tree_unflatten(
        treedef, [jax.device_put(x, rep)
                  for x in jax.tree_util.tree_leaves(tree["opt_state"])])
    return {"params": params, "opt_state": opt_state,
            "step": jax.device_put(np.asarray(tree["step"]), rep)}


_STEPS = {}


def _jax_step(name, jmod, cfg, mesh, rules):
    """value_and_grad of the loss and the optimizer on the mesh, jitted
    once per model (and compiled once per mesh and rules): step(state,
    batch) → (state, loss)."""
    if name not in _STEPS:
        _STEPS[name] = _jitted_step(name, jmod, cfg)
    step = _STEPS[name]

    def run(state, batch):
        with jax.default_matmul_precision("highest"), mesh:
            return step(state, _place_batch(mesh, jmod, rules, batch))
    return run


def _jitted_step(name, jmod, cfg):
    opt = _jax_adamw()
    loss_fn = _jax_loss(name, jmod, cfg)

    @jax.jit
    def step(state, b):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state["params"], b)
        updates, opt_state = opt.update(grads, state["opt_state"],
                                        state["params"])
        return ({"params": optax.apply_updates(state["params"], updates),
                 "opt_state": opt_state, "step": state["step"] + 1}, loss)
    return step


def _pspecs(jmod, cfg, rules, flat):
    """Each parameter leaf's JAX spec under ``rules``, normalized, by its
    path below "params"."""
    leaves = jax.tree_util.tree_leaves_with_path(
        jmod.param_specs(cfg, rules),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, spec in leaves:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = jsc.normalize_spec(spec, flat["params/" + name].ndim)
    return out


def _expected_spec(path, flat, pspecs):
    """A leaf's spec as the JAX package shards it: a parameter's by the
    model's specs, an AdamW moment (``opt_state/0/{1,2}/<param>``) by its
    parameter's, the counts replicated."""
    top, _, rest = path.partition("/")
    if top == "params":
        return pspecs[rest]
    param = "/".join(path.split("/")[3:])
    return pspecs[param] if top == "opt_state" and param else []


@pytest.fixture(scope="module")
def saved(pools, tmp_path_factory):
    """One 8-rank save per model, made on first use: (the ranks' results,
    the JAX package's handle on the manifest)."""
    done = {}

    def get(model):
        if model not in done:
            name, mesh_cfg, rules = SAVES[model]
            jmod, _, preset = MODULES[name]
            results = pools[8].run(
                "zoo_ckpt_save", name, preset, mesh_cfg, rules,
                jax_params(jmod, preset), _batches(name, SAVE_STEPS, 20), LR,
                str(tmp_path_factory.mktemp(f"zoo-{model}")))
            done[model] = (results, jsc.ShardedCheckpoint.from_manifest_uri(
                results[0]["uri"]))
        return done[model]
    return get


@pytest.mark.parametrize("model", sorted(SAVES))
def test_eight_ranks_save_their_blocks_of_the_zoo_state(saved, model):
    results, ckpt = saved(model)
    name, mesh_cfg, _ = SAVES[model]
    sizes = _sizes(mesh_cfg)
    assert ckpt.world_size == 8 and dict(ckpt.mesh_axes) == sizes
    whole, _ = jsc.flatten_tree(ckpt.load_full())
    assert int(whole["step"]) == SAVE_STEPS
    if name == "t5":
        # Each of T5's stacks is one leaf per weight, layers first.
        cfg = MODULES[name][0].config(MODULES[name][2])
        assert whole["params/encoder/attn/wq"].shape[0] == \
            cfg.n_encoder_layers
        assert whole["params/decoder/cross/wo"].shape[0] == \
            cfg.n_decoder_layers
    _assert_blocks(results, whole,
                   lambda p, shape: ckpt.manifest["specs"][p], sizes)


@pytest.mark.parametrize("model,mesh_cfg,rules,route", RESTORES)
def test_four_ranks_resume_the_zoo_state_from_eight(pools, saved, model,
                                                    mesh_cfg, rules, route):
    _, ckpt = saved(model)
    _hold_resume(pools, ckpt, SAVES[model][0], mesh_cfg, rules, route)


def test_a_state_saved_with_the_sequence_over_sp_resumes_without_it(
        pools, tmp_path):
    """bert-tiny trained on fsdp=2, sp=2 under context_parallel_rules()
    (its sequence split over sp) and saved: every rank's blocks are the
    saved tree's, and each shard is written once, by the rank at sp index
    0 (its twin at index 1 is listed with the same file). 4 ranks on
    fsdp=4 under tp_fsdp_rules() restore it bit-equal and resume."""
    jmod, _, preset = MODULES["bert"]
    save_mesh = dict(fsdp=2, sp=2)
    results = pools[4].run("zoo_ckpt_save", "bert", preset, save_mesh,
                           "context_parallel_rules", jax_params(jmod, preset),
                           _batches("bert", SAVE_STEPS, 20), LR,
                           str(tmp_path))
    ckpt = jsc.ShardedCheckpoint.from_manifest_uri(results[0]["uri"])
    sizes = _sizes(save_mesh)
    whole, _ = jsc.flatten_tree(ckpt.load_full())
    assert int(whole["step"]) == SAVE_STEPS
    _assert_blocks(results, whole,
                   lambda p, shape: ckpt.manifest["specs"][p], sizes)
    files = {s["rank"]: s["file"] for s in ckpt.manifest["shards"]}
    assert sorted(files) == [0, 1, 2, 3]
    for rank, r in enumerate(results):
        # The writer: the rank at sp index 0 beside this one.
        writer = rank - r["coords"]["sp"]
        assert files[rank] == files[writer]
        assert files[rank].endswith(f".shard-{writer:04d}")
    on_disk = [f for f in spill.FileSpillBackend(str(tmp_path)).list_files()
               if ".shard-" in f]
    assert sorted(on_disk) == sorted(set(files.values()))
    assert len(on_disk) == 2
    _hold_resume(pools, ckpt, "bert", dict(fsdp=4), "tp_fsdp_rules",
                 "load_for_rank")


def _hold_resume(pools, ckpt, name, mesh_cfg, rules, route):
    """4 ranks restore ``ckpt`` on ``mesh_cfg`` under ``rules`` and take
    one step: the route, every block the saved tree's, the step's loss
    and the parameters after it held to the port's step from the same
    tree without a mesh."""
    jmod, _, preset = MODULES[name]
    batch = _batches(name, 1, 30)[0]
    cid = pools[4].submit("zoo_ckpt_restore", name, preset, mesh_cfg, rules,
                          LR, ckpt.uri, batch, SAVE_STEPS)
    whole, _ = jsc.flatten_tree(ckpt.load_full())
    cfg, jrules = jmod.config(preset), _jax_rules(rules)
    # The reference: the same checkpoint resumed without a mesh, one step
    # (the port's steps are held to the JAX package's in
    # tests/test_torch_zoo_mesh.py and below).
    state, opt = _port_state(name, seed=9)
    state, loss = _port_step(name, restore_train_state(
        state, ShardedCheckpoint.from_manifest_uri(ckpt.uri)), opt, batch)
    after, _ = jsc.flatten_tree(
        {"params": MODULES[name][1].to_jax_params(state["params"])})
    results = pools[4].result(cid)

    sizes = _sizes(mesh_cfg)
    pspecs = _pspecs(jmod, cfg, jrules, whole)
    assert all(r["route"] == route for r in results)
    _assert_blocks(results, whole,
                   lambda p, shape: _expected_spec(p, whole, pspecs),
                   sizes)
    np.testing.assert_allclose([r["loss"] for r in results], loss,
                               rtol=STEP_RTOL)
    groups = _params.leaf_groups(state["params"])
    for r in results:
        assert r["step"] == SAVE_STEPS
        # The parameters after the step, as the JAX layout's blocks.
        for leaf, names in groups.items():
            path = "params/" + leaf.replace(".", "/")
            spec = pspecs[path[len("params/"):]]
            want = after[path][jsc.shard_slices(after[path].shape, spec,
                                                sizes, r["coords"])]
            got = (np.stack([r["after"][n] for n in names])
                   if _params.stacked(leaf, names) else r["after"][names[0]])
            np.testing.assert_allclose(got, want, atol=PARAM_ATOL,
                                       rtol=STEP_RTOL, err_msg=leaf)


def _port_state(name, seed):
    """A fresh train state of the zoo model without a mesh, and its
    AdamW (weight decay 0)."""
    _, tmod, preset = MODULES[name]
    model = tmod.init(tmod.config(preset), torch.Generator().manual_seed(seed),
                      "cpu")
    opt = optim.adamw(lambda c: torch.tensor(LR, dtype=torch.float32),
                      weight_decay=0.0)
    return {"params": model,
            "opt_state": opt.init(dict(model.named_parameters()),
                                  tmod.leaf_groups(model)),
            "step": torch.zeros((), dtype=torch.int32)}, opt


def _port_step(name, state, opt, batch):
    """One step of the loss (BERT's ``mlm_loss``, else ``loss_fn``) →
    ``autograd.grad`` (zeros where the loss does not reach a parameter,
    as BERT's pooler) → AdamW → (state, loss)."""
    _, tmod, _ = MODULES[name]
    model = state["params"]
    named = dict(model.named_parameters())
    batch = [torch.from_numpy(x) for x in batch]
    loss = (tmod.mlm_loss(model, *batch) if name == "bert"
            else tmod.loss_fn(model, *batch)[0])
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        named.values(), torch.autograd.grad(loss, list(named.values()),
                                            allow_unused=True))]
    with torch.no_grad():
        updates, opt_state = opt.update(dict(zip(named, grads)),
                                        state["opt_state"], named)
        optim.apply_updates(named, updates)
    return ({"params": model, "opt_state": opt_state,
             "step": state["step"] + 1}, float(loss.detach()))


# -- t5-tiny between the packages --------------------------------------

T5 = MODULES["t5"]


def _port_flat(state):
    model = state["params"]
    groups = _params.leaf_groups(model)
    tree = {"params": optim.to_jax_tree(dict(model.named_parameters()),
                                        groups, "cpu"),
            "opt_state": optim.to_optax_state(state["opt_state"], groups,
                                              "cpu"),
            "step": state["step"]}
    flat, structure = sc.flatten_tree(tree)
    return {p: v.detach().numpy() for p, v in flat.items()}, structure


def _assert_params_close(model, want):
    got, _ = sc.flatten_tree(T5[1].to_jax_params(model))
    want, _ = sc.flatten_tree(want)
    for p, w in want.items():
        np.testing.assert_allclose(got[p], w, atol=PARAM_ATOL,
                                   rtol=STEP_RTOL, err_msg=p)


def test_jax_written_t5_checkpoint_resumes_in_the_port(tmp_path):
    jmod, _, preset = T5
    cfg = jmod.config(preset)
    rules = _jax_rules("tp_fsdp_rules")
    mesh = build_mesh(MeshConfig(fsdp=2, tp=2), devices=jax.devices("cpu")[:4])
    params = jax_params(jmod, preset)
    state = _jax_state_on(mesh, {"params": params,
                                 "opt_state": _jax_adamw().init(params),
                                 "step": np.int32(0)}, jmod, cfg, rules)
    step = _jax_step("t5", jmod, cfg, mesh, rules)
    for b in _batches("t5", SAVE_STEPS, 40):
        state, _ = step(state, b)
    specs_tree = jax.tree_util.tree_map(
        lambda x: x.sharding.spec if isinstance(
            getattr(x, "sharding", None), NamedSharding) else None, state)
    tree = jax.tree_util.tree_map(np.array, state)
    batch = _batches("t5", 1, 50)[0]
    state, jloss = step(state, batch)
    jafter = jax.tree_util.tree_map(np.asarray, state["params"])
    flat, structure = jsc.flatten_tree(tree)
    specs = sc.flatten_like(structure, specs_tree)
    axes = list(mesh.shape.items())
    backend = spill.FileSpillBackend(str(tmp_path))
    records = [jsc.write_shard(backend, "jax", 1, rank,
                               jsc.extract_local_shard(flat, specs, axes,
                                                       rank))
               for rank in range(mesh.size)]
    meta = jsc.build_tree_meta(flat, structure, specs, axes)
    uri = jsc.write_manifest(backend, "jax", 1,
                             jsc.build_manifest("jax", 1, meta, records))

    port, opt = _port_state("t5", seed=5)
    ckpt = ShardedCheckpoint.from_manifest_uri(uri)
    assert restore_route(ckpt, port) == "load_full"
    port = restore_train_state(port, ckpt)
    got, _ = _port_flat(port)
    assert set(got) == set(flat)
    for p, want in flat.items():
        assert got[p].dtype == want.dtype, p
        np.testing.assert_array_equal(got[p], want, err_msg=p)
    port, loss = _port_step("t5", port, opt, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=STEP_RTOL)
    _assert_params_close(port["params"], jafter)
    assert int(port["step"]) == SAVE_STEPS + 1


def test_port_written_t5_checkpoint_resumes_in_jax(tmp_path):
    port, opt = _port_state("t5", seed=3)
    for b in _batches("t5", SAVE_STEPS, 60):
        port, _ = _port_step("t5", port, opt, b)
    handle = save_train_state(port, CheckpointManager(str(tmp_path), "port"))
    flat, structure = _port_flat(port)
    jckpt = jsc.ShardedCheckpoint.from_manifest_uri(handle.uri)
    assert jckpt.manifest["structure"] == structure
    jflat, _ = jsc.flatten_tree(jckpt.load_full())
    assert set(jflat) == set(flat)
    for p, want in flat.items():
        assert jflat[p].dtype == want.dtype, p
        np.testing.assert_array_equal(jflat[p], want, err_msg=p)

    jmod, _, preset = T5
    cfg, rules = jmod.config(preset), _jax_rules("tp_fsdp_rules")
    mesh = build_mesh(MeshConfig(fsdp=2, tp=2),
                      devices=jax.devices("cpu")[:4])
    batch = _batches("t5", 1, 70)[0]
    jstate = _jax_state_on(mesh, jckpt.load_full(), jmod, cfg, rules)
    jstate, jloss = _jax_step("t5", jmod, cfg, mesh, rules)(jstate, batch)
    port, loss = _port_step("t5", port, opt, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=STEP_RTOL)
    _assert_params_close(port["params"], jax.tree_util.tree_map(
        np.asarray, jstate["params"]))

"""The port's mesh and sharding rules against the JAX package's, in one
process.

Meshes are built over torch's fake process group (rank 3 of a world of 8,
no communication), against the JAX package's meshes on the 8 fake CPU
devices of ``tests/conftest.py``. Random shapes come from numpy with a
fixed seed.
"""

import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsharding
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.train import torch as ttrain

PRESETS = ("dp_rules", "fsdp_rules", "tp_fsdp_rules",
           "context_parallel_rules")


@pytest.fixture
def fake_world():
    """This process as rank 3 of 8 in a fake process group."""
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("kwargs,n", [
    (dict(dp=2, fsdp=-1, tp=2), 8),
    (dict(dp=3, fsdp=1, tp=1), 8),
    (dict(dp=-1, fsdp=-1), 8),
    (dict(), 8),
    (dict(tp=-1, fsdp=2), 8),
    (dict(dp=2, fsdp=3), 8),
    (dict(fsdp=-1, tp=3), 8),
    (dict(slices=2, dp=2, fsdp=2, tp=-1), 8),
    (dict(slices=2, dp=1, fsdp=-1), 8),
    (dict(slices=3, dp=3, fsdp=-1), 8),
    (dict(dp=1, fsdp=1, tp=1, sp=1, ep=1), 1),
])
def test_mesh_config_resolves_as_the_reference(kwargs, n):
    def resolved(module):
        cfg = module.MeshConfig(**kwargs).resolve(n)
        return cfg.shape(), cfg.batch_shards, cfg.slices, cfg.axis_names
    assert _outcome(lambda: resolved(tmesh)) == _outcome(
        lambda: resolved(jmesh))
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.BATCH_AXES == jmesh.BATCH_AXES


def test_build_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.build_mesh(tmesh.MeshConfig(), "cpu")


@pytest.mark.parametrize("kwargs", [
    dict(dp=2, fsdp=2, tp=2),
    dict(dp=8, fsdp=1),
    dict(fsdp=-1, tp=4),
    dict(slices=2, dp=2, fsdp=2, tp=-1),
    dict(slices=2, dp=4, fsdp=-1),
])
def test_build_mesh_lays_ranks_out_as_the_jax_mesh(fake_world, kwargs):
    mesh = tmesh.build_mesh(tmesh.MeshConfig(**kwargs), "cpu")
    jax_mesh = jmesh.build_mesh(jmesh.MeshConfig(**kwargs),
                                devices=jax.devices("cpu")[:8])
    ids = np.vectorize(lambda d: d.id)(jax_mesh.devices)
    assert mesh.mesh_dim_names == jax_mesh.axis_names
    assert np.array_equal(mesh.mesh.numpy(), ids)
    assert tmesh.mesh_sizes(mesh) == dict(jax_mesh.shape)
    assert np.array_equal(
        np.argwhere(ids == 3)[0], mesh.get_coordinate())


def test_current_mesh_registry(fake_world):
    """The eval step makes its mesh and rules current for the length of a
    call, and then restores what was current before, also when the call
    fails: a forward outside the step never inherits its layout."""
    mesh = tmesh.build_mesh(tmesh.MeshConfig(dp=2, fsdp=2, tp=2), "cpu")
    cfg = tgpt.config("gpt-micro")
    rules = tsharding.tp_fsdp_rules()
    seen = []

    class Probe:  # the step reads model.cfg first
        @property
        def cfg(self):
            seen.append((tmesh.current_mesh(), tmesh.current_rules()))
            raise AttributeError("probe")

    assert tmesh.current_mesh() is None
    step = tts.make_eval_step(cfg, mesh, rules)
    outer = tmesh.build_mesh(tmesh.MeshConfig(dp=1, fsdp=8), "cpu")
    with tmesh.registered_mesh(outer):
        with pytest.raises(AttributeError, match="probe"):
            step(Probe(), {})
        assert seen == [(mesh, rules)]
        assert tmesh.current_mesh() is outer
        assert tmesh.current_rules() is None
    assert tmesh.current_mesh() is None


LOGICAL = [("layers", "embed", "heads", None), ("batch", "sequence"),
           ("vocab", "embed"), ("embed", "kv_heads", "head_dim"),
           ("expert", "embed", "mlp"), ("mlp",), (None, None), ()]


@pytest.mark.parametrize("preset", PRESETS)
def test_rules_presets_give_the_jax_specs(preset):
    port, ref = getattr(tsharding, preset)(), getattr(jsharding, preset)()
    for axes in LOGICAL:
        assert tuple(port.spec(*axes)) == tuple(ref.spec(*axes)), axes
    custom = dict(batch=None, embed=None, heads=None, kv_heads=None,
                  mlp=None, vocab=None)
    assert tuple(tsharding.ShardingRules(**custom).spec(*LOGICAL[0])) == \
        tuple(jsharding.ShardingRules(**custom).spec(*LOGICAL[0]))


def test_shard_slice_math_matches_the_reference():
    rng = np.random.default_rng(0)
    names = ("dp", "fsdp", "tp")
    for _ in range(300):
        sizes = {a: int(rng.integers(1, 5)) for a in names}
        coords = {a: int(rng.integers(0, sizes[a])) for a in names}
        shape = tuple(int(x) for x in rng.integers(1, 20, rng.integers(1, 4)))
        axes = list(rng.permutation(names))
        spec = []
        for _ in shape:
            pick = rng.integers(0, 4)
            if pick == 0 or not axes:
                spec.append(None)
            elif pick == 1 and len(axes) >= 2:
                spec.append((axes.pop(), axes.pop()))
            else:
                spec.append(axes.pop())
        spec = spec[:int(rng.integers(0, len(spec) + 1))]
        assert tsharding.shard_slices(shape, spec, sizes, coords) == \
            jsharding.shard_slices(shape, spec, sizes, coords)
        dim, n = int(rng.integers(0, 30)), int(rng.integers(1, 9))
        assert tsharding.axis_split_bounds(dim, n) == \
            jsharding.axis_split_bounds(dim, n)
        a = tuple(slice(*sorted(rng.integers(0, 10, 2))) for _ in range(2))
        b = tuple(slice(*sorted(rng.integers(0, 10, 2))) for _ in range(2))
        assert tsharding.slices_overlap(a, b) == jsharding.slices_overlap(a, b)
    with pytest.raises(ValueError):
        tsharding.axis_split_bounds(4, 0)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("model", ["gpt-tiny", "gpt-micro", "llama-micro"])
def test_param_specs_are_the_jax_specs_without_the_layer_axis(model, preset):
    port_mod, ref_mod = ((tllama, jllama) if model.startswith("llama")
                         else (tgpt, jgpt))
    port = port_mod.param_specs(port_mod.config(model),
                                getattr(tsharding, preset)())
    ref = ref_mod.param_specs(ref_mod.config(model),
                              getattr(jsharding, preset)())
    assert sorted(port) == sorted(ref)
    assert sorted(port["layers"]) == sorted(ref["layers"])
    for name, spec in ref["layers"].items():
        assert spec[0] is None and tuple(port["layers"][name]) == \
            tuple(spec)[1:], name
    for name in ref:
        if name != "layers":
            assert tuple(port[name]) == tuple(ref[name]), name
    rules = getattr(tsharding, preset)()
    assert tuple(port_mod.batch_spec(rules)) == tuple(
        ref_mod.batch_spec(getattr(jsharding, preset)()))


def test_pipeline_rules_and_moe_wait_for_item_8():
    """Item 8 has landed: the MoE specs are the JAX package's less the
    layer axis under every preset. ``rules.layers`` (the stacked layer
    axis over pipeline stages) still waits, for item 12."""
    pipeline = tsharding.ShardingRules(layers="pp")
    with pytest.raises(NotImplementedError, match="item 12"):
        tgpt.param_specs(tgpt.config("gpt-micro"), pipeline)
    with pytest.raises(NotImplementedError, match="item 12"):
        tllama.param_specs(tllama.config("llama-micro"), pipeline)
    for preset in PRESETS:
        port = tgpt.param_specs(tgpt.config("gpt-moe-tiny"),
                                getattr(tsharding, preset)())
        ref = jgpt.param_specs(jgpt.config("gpt-moe-tiny"),
                               getattr(jsharding, preset)())
        assert sorted(port["layers"]) == sorted(ref["layers"])
        for name, spec in ref["layers"].items():
            assert tuple(port["layers"][name]) == tuple(spec)[1:], name
    moe = tgpt.param_specs(tgpt.config("gpt-moe-tiny"),
                           tsharding.tp_fsdp_rules())["layers"]
    assert tuple(moe["w_in"]) == ("ep", "fsdp", "tp")
    assert tuple(moe["router"]) == ("fsdp", None)


@pytest.mark.parametrize("kwargs", [dict(fsdp=4, sp=2), dict(fsdp=4, ep=2),
                                    dict(fsdp=4, pp=2)])
def test_sp_ep_pp_above_one_wait_for_item_8(fake_world, kwargs):
    """Item 8 has landed: on rank 3 of 8 the experts are split over ep,
    the batch's columns over sp, and everything is replicated over pp."""
    mesh = tmesh.build_mesh(tmesh.MeshConfig(**kwargs), "cpu")
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    rules = tsharding.context_parallel_rules()
    cfg = tgpt.config("gpt-moe-tiny")
    state = tts.init_train_state(cfg, mesh, rules, device="cpu")
    params = dict(state["params"].named_parameters())
    ep = kwargs.get("ep", 1)
    w_in = params["blocks.0.w_in"]
    names = w_in.device_mesh.mesh_dim_names
    assert names == ("dp", "fsdp", "tp", "ep")
    assert w_in.placements[names.index("ep")] == Shard(0)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert tuple(w_in.to_local().shape) == (E // ep, d // 4, f)
    for name, p in params.items():  # pp and sp split nothing
        assert not {"sp", "pp"} & set(p.device_mesh.mesh_dim_names), name
    wq = params["blocks.0.wq"]
    assert tuple(wq.to_local().shape) == (d // 4, cfg.n_heads, cfg.head_dim)
    tokens = torch.arange(8 * 16).reshape(8, 16)
    got = tts._Batching(mesh, rules).local({"tokens": tokens})["tokens"]
    sp = kwargs.get("sp", 1)
    rows, cols = 8 // 4, 16 // sp
    assert torch.equal(got, tokens[coords["fsdp"] * rows:
                                   (coords["fsdp"] + 1) * rows,
                                   coords["sp"] * cols:
                                   (coords["sp"] + 1) * cols])
    tts.make_train_step(cfg, mesh, rules)
    tllama.init(tllama.config("llama-micro"), torch.Generator(), "cpu",
                mesh=mesh, rules=rules)


def test_tp_that_splits_kv_heads_unevenly_raises(fake_world):
    mesh = tmesh.build_mesh(tmesh.MeshConfig(dp=1, fsdp=1, tp=8), "cpu")
    cfg = tllama.config("llama-micro")  # 8 query heads over 4 KV heads
    with pytest.raises(ValueError, match="kv_heads|KV heads"):
        tsharding.shard_model(tllama.Llama(cfg, "meta"), mesh,
                              tllama.param_specs(cfg,
                                                 tsharding.tp_fsdp_rules()))


def test_local_heads_must_keep_the_grouping():
    cfg = tllama.config("llama-micro")  # 8 over 4
    q = torch.zeros(1, 64, 4, 16)
    with pytest.raises(ValueError, match="grouping"):
        tllama._attention(q, torch.zeros(1, 64, 4, 16), q, cfg)


def test_specs_the_port_cannot_place_raise(fake_world):
    mesh = tmesh.build_mesh(tmesh.MeshConfig(dp=2, fsdp=2, tp=2), "cpu")
    cfg = tgpt.config("gpt-micro")
    for rules in (tsharding.ShardingRules(embed=("fsdp", "tp")),
                  tsharding.ShardingRules(embed="dp")):
        with pytest.raises(NotImplementedError, match="one axis"):
            tsharding.shard_model(tgpt.GPT(cfg, "meta"), mesh,
                                  tgpt.param_specs(cfg, rules))
    with pytest.raises(NotImplementedError, match="batch"):
        tts.make_train_step(cfg, mesh, tsharding.ShardingRules(batch="tp"))
    with pytest.raises(ValueError, match="mesh"):
        tts.make_train_step(cfg, None, tsharding.tp_fsdp_rules())


def test_a_batch_that_does_not_split_evenly_raises(fake_world):
    mesh = tmesh.build_mesh(tmesh.MeshConfig(dp=2, fsdp=2, tp=2), "cpu")
    batching = tts._Batching(mesh, tsharding.tp_fsdp_rules())
    ok = batching.local({"tokens": torch.arange(8).reshape(8, 1)})
    # rank 3 sits at dp 0, fsdp 1: the second of four blocks of 2 rows.
    assert ok["tokens"].flatten().tolist() == [2, 3]
    with pytest.raises(ValueError, match="split evenly"):
        batching.local({"tokens": torch.zeros(6, 4)})


def test_flash_attention_refuses_a_dtensor(fake_world):
    mesh = tmesh.build_mesh(tmesh.MeshConfig(dp=1, fsdp=1, tp=8), "cpu")
    q = torch.zeros(1, 128, 2, 16)
    dq = DTensor.from_local(q, mesh["tp"], [Replicate()], run_check=False)
    with pytest.raises(TypeError, match="local_map"):
        fa.flash_attention(dq, dq, dq)
    with pytest.raises(TypeError, match="local_map"):
        fa._flash_forward(dq, dq, dq, True, 128, 128)


def test_process_group_start_needs_all_or_none_of_its_variables(
        monkeypatch):
    for name in ttrain.ENV_VARS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(ValueError, match="MASTER_PORT"):
        ttrain.distributed_init_if_needed("cpu")
    assert not dist.is_initialized()


def test_rank_zero_holds_its_store_port_until_its_group_takes_it(
        monkeypatch):
    """The port a gang meets on is bound by rank 0 before anyone is told
    it: no other process can take it in between, and rank 0's group
    starts on the store that holds it."""
    port = ttrain.bind_store(1)
    with socket.socket() as s, pytest.raises(OSError):
        s.bind(("127.0.0.1", port))
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("RAY_TPU_WORLD_SIZE", "1")
    monkeypatch.setenv("RAY_TPU_RANK", "0")
    ttrain.distributed_init_if_needed("cpu")
    try:
        assert dist.get_world_size() == 1 and ttrain._bound is None
    finally:
        dist.destroy_process_group()


def test_prepare_mesh_starts_a_one_rank_group(monkeypatch):
    for name in ttrain.ENV_VARS:
        monkeypatch.delenv(name, raising=False)
    mesh = ttrain.prepare_mesh(tmesh.MeshConfig(dp=1, fsdp=1), "cpu")
    try:
        assert dist.get_backend() == "gloo"
        assert dist.get_world_size() == 1 and mesh.size() == 1
        ttrain.distributed_init_if_needed("cpu")  # once only
    finally:
        dist.destroy_process_group()

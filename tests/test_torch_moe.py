"""The port's mixture-of-experts GPT against the JAX package's.

gpt-moe-tiny (2 layers, 4 experts, top-2, capacity factor 1.25) carried
over from the reference's init with ``from_jax_params``: forward, aux
term, loss and gradients, routing, the one-expert-equals-dense case,
train steps and Adafactor's factoring plan in this process (the JAX side
under "highest" matmul precision); then on gloo ranks
(``tests/_torch_ranks.py``) against the JAX step on the same mesh of the
8 fake CPU devices: experts over ``ep``, and the sequence over ``sp``
(whose capacity drops must be one device's). The checkpoint of experts
split over ``ep``, saved by 8 ranks and resumed by 4, is in
``tests/test_torch_checkpoint_ranks.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_ranks import RankPool
from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.parallel.sharding import shard_slices
from test_torch_sharded import (PARAM_ATOL, STEP_RTOL, _check_blocks,
                                _check_plain_forward)

PRESET = "gpt-moe-tiny"
# tests/test_torch_gpt.py's bounds: fp32 summation order.
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
# tests/test_parallel_extra.py:58: one expert, top-1, ample capacity.
DENSE_TOL = 2e-4
# One device's MoE layer against each rank's block of it on a mesh: fp32
# summation order of the same products.
LAYER_TOL = 1e-5
B, S = 4, 32

OPTIMIZERS = {
    "adamw": lambda m: m.default_optimizer(1e-3, warmup_steps=1),
    "adafactor": lambda m: m.memory_efficient_optimizer(1e-2,
                                                        warmup_steps=1),
}


@pytest.fixture(scope="module")
def pool():
    pool = RankPool(8)
    yield pool
    pool.close()


def _params(seed=0, **overrides):
    cfg = jgpt.config(PRESET, **overrides)
    return jax.tree_util.tree_map(
        np.asarray, jgpt.init(cfg, jax.random.PRNGKey(seed)))


def _batches(n, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, 256, (B, S), dtype=np.int32),
             "targets": rng.integers(0, 256, (B, S), dtype=np.int32)}
        if mask:
            b["mask"] = rng.integers(0, 2, (B, S)).astype(np.float32)
        out.append(b)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _grad_tree(model):
    grads = {n: p.grad.numpy() for n, p in model.named_parameters(
        recurse=False)}
    grads["layers"] = {
        n: np.stack([dict(b.named_parameters())[n].grad.numpy()
                     for b in model.blocks])
        for n, _ in model.blocks[0].named_parameters()}
    return grads


# -- one process --------------------------------------------------------

@pytest.mark.parametrize("remat,policy,chunk", [
    (False, "full", 0), (True, "full", 0), (True, "selective", 32)],
    ids=["plain", "full-remat", "selective-chunked"])
def test_forward_aux_loss_and_gradients_match_jax(remat, policy, chunk):
    opts = dict(remat=remat, remat_policy=policy, loss_chunk=chunk)
    params = _params()
    jcfg = jgpt.config(PRESET, **opts)
    b = _batches(1, seed=3, mask=True)[0]

    def loss(p):
        return jgpt.loss_fn(p, jcfg, b["tokens"], b["targets"], b["mask"],
                            z_loss=1e-4)
    with jax.default_matmul_precision("highest"):
        ref_logits, ref_aux = jax.jit(
            lambda p: jgpt.forward_with_aux(p, jcfg, b["tokens"]))(params)
        (ref_loss, ref_m), ref_g = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)

    model = tgpt.from_jax_params(params, tgpt.config(PRESET, **opts), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        logits, aux = model.forward_with_aux(tb["tokens"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=LOSS_RTOL)
    assert float(aux) > 0.5  # the reference's test_moe_forward_and_aux
    got_loss, got_m = tgpt.loss_fn(model, tb["tokens"], tb["targets"],
                                   tb["mask"], z_loss=1e-4)
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(ref_loss),
                               rtol=LOSS_RTOL)
    for key in ("loss", "accuracy", "perplexity"):
        np.testing.assert_allclose(float(got_m[key]), float(ref_m[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    want, got = _flat(jax.tree_util.tree_map(np.asarray, ref_g)), \
        _flat(_grad_tree(model))
    assert sorted(want) == sorted(got)
    for name, arr in want.items():
        np.testing.assert_allclose(got[name], arr, atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_routing_agrees_with_jax(monkeypatch):
    """Each layer's top-k experts are the reference's, and the router's
    smallest gap between a token's k-th and (k+1)-th probability is wider
    than the two packages' difference in probabilities: a routing flip
    would show here as one, not as a tolerance failure elsewhere."""
    params = _params()
    cfg = jgpt.config(PRESET)
    K = cfg.expert_top_k
    tokens = _batches(1, seed=3)[0]["tokens"]
    ref_probs = []
    with jax.default_matmul_precision("highest"):
        x = jnp.take(params["wte"], tokens, axis=0)
        pos = jnp.broadcast_to(jnp.arange(S), (B, S))
        for i in range(cfg.n_layers):
            layer = {k: v[i] for k, v in params["layers"].items()}
            h = jgpt._layernorm(x, layer["ln1_scale"], layer["ln1_bias"],
                                cfg.layernorm_eps)
            ref_probs.append(np.asarray(jax.nn.softmax(h @ layer["router"])))
            x, _ = jgpt._block(cfg, x, layer, pos)

    got_probs, moe_ffn = [], tgpt._moe_ffn

    def recording(cfg, h, block):
        got_probs.append(torch.softmax(h @ block.router, -1).detach())
        return moe_ffn(cfg, h, block)
    monkeypatch.setattr(tgpt, "_moe_ffn", recording)
    model = tgpt.from_jax_params(params, tgpt.config(PRESET), "cpu")
    with torch.no_grad():
        model(torch.from_numpy(tokens))
    assert len(got_probs) == cfg.n_layers
    for ref, got in zip(ref_probs, got_probs):
        got = got.numpy()
        order = np.argsort(-ref, axis=-1, kind="stable")
        ref_top = jax.lax.top_k(jnp.asarray(ref), K)[1]
        np.testing.assert_array_equal(np.asarray(ref_top), order[..., :K])
        got_top = torch.sort(torch.from_numpy(got), dim=-1, descending=True,
                             stable=True).indices[..., :K].numpy()
        np.testing.assert_array_equal(got_top, np.asarray(ref_top))
        srt = -np.sort(-ref, axis=-1)
        gap = float((srt[..., K - 1] - srt[..., K]).min())
        assert gap > np.abs(got - ref).max(), gap


def test_one_expert_matches_dense():
    """The reference's test_moe_matches_dense_when_one_expert in the port:
    a 1-expert MoE with top_k=1 and ample capacity is the dense FFN routed
    through the einsums."""
    dense_cfg = tgpt.config("gpt-tiny")
    moe_cfg = tgpt.config("gpt-tiny", n_experts=1, expert_top_k=1,
                          capacity_factor=2.0)
    dense = jax.tree_util.tree_map(
        np.asarray, jgpt.init(jgpt.config("gpt-tiny"),
                              jax.random.PRNGKey(1)))
    moe = jax.tree_util.tree_map(
        np.asarray, jgpt.init(jgpt.config("gpt-tiny", n_experts=1),
                              jax.random.PRNGKey(1)))
    for k in ("w_in", "b_in", "w_out"):
        moe["layers"][k] = dense["layers"][k][:, None]
    for k in ("wte", "lnf_scale", "lnf_bias", "lm_head", "lm_head_bias"):
        moe[k] = dense[k]
    for k in ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo", "b_out"):
        moe["layers"][k] = dense["layers"][k]
    tokens = torch.arange(32).reshape(1, 32) % 256
    with torch.no_grad():
        out_dense = tgpt.from_jax_params(dense, dense_cfg, "cpu")(tokens)
        out_moe = tgpt.from_jax_params(moe, moe_cfg, "cpu")(tokens)
    np.testing.assert_allclose(out_moe.numpy(), out_dense.numpy(),
                               rtol=DENSE_TOL, atol=DENSE_TOL)
    with jax.default_matmul_precision("highest"):
        ref = jgpt.forward(moe, jgpt.config("gpt-tiny", n_experts=1,
                                            expert_top_k=1,
                                            capacity_factor=2.0),
                           jnp.asarray(tokens.numpy(), jnp.int32))
    np.testing.assert_allclose(out_moe.numpy(), np.asarray(ref),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_train_steps_match_jax(opt):
    cfg = jgpt.config(PRESET)
    mesh = build_mesh(MeshConfig(dp=1, fsdp=1, tp=1),
                      devices=jax.devices("cpu")[:1])
    rules = jsharding.dp_rules()
    jopt = OPTIMIZERS[opt](jts)
    batches = _batches(3, mask=True)
    with jax.default_matmul_precision("highest"):
        state = jts.init_train_state(cfg, mesh, rules, jopt, seed=0)
        params0 = jax.tree_util.tree_map(np.asarray, state["params"])
        step = jts.make_train_step(cfg, mesh, rules, jopt)
        ref = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            ref.append({k: float(v) for k, v in m.items()})
        params1 = jax.tree_util.tree_map(np.asarray, state["params"])

    topt = OPTIMIZERS[opt](tts)
    model = tgpt.from_jax_params(params0, tgpt.config(PRESET), "cpu")
    tstate = {"params": model,
              "opt_state": topt.init(dict(model.named_parameters()),
                                     tgpt.leaf_groups(model)),
              "step": torch.zeros((), dtype=torch.int32)}
    tstep = tts.make_train_step(model.cfg, optimizer=topt)
    for b, want in zip(batches, ref):
        tstate, m = tstep(tstate, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        for k in want:
            assert float(m[k]) == pytest.approx(want[k], rel=STEP_RTOL), k
    got = _flat(tgpt.to_jax_params(model))
    for name, arr in _flat(params1).items():
        np.testing.assert_allclose(got[name], arr, atol=PARAM_ATOL,
                                   rtol=STEP_RTOL, err_msg=name)


def _optax_factored(shape):
    from optax._src import factorized
    dims = factorized._factored_dims(shape, True, 128)
    return None if dims is None else tuple(sorted(dims))


@pytest.mark.parametrize("preset", ["gpt-moe-tiny", "gpt-moe-8x410m"])
def test_adafactor_factors_the_stacked_moe_leaves_as_optax(preset):
    """Adafactor's plan on the stacked MoE leaves is optax's: at
    gpt-moe-8x410m w_in and w_out [24, 8, 1024, 4096] over their last two
    dims, b_in [24, 8, 4096] and router [24, 1024, 8] not at all (24 <
    128); none reaches the layer axis. The model is built on the meta
    device."""
    cfg = tgpt.config(preset)
    model = tgpt.GPT(cfg, "meta")
    params = dict(model.named_parameters())
    groups = tgpt.leaf_groups(model)
    plan = optim._factor_plan(params, groups, 128)
    for leaf, names in groups.items():
        stacked = len(names) > 1
        shape = ((len(names),) * stacked + tuple(params[names[0]].shape))
        want = _optax_factored(shape)
        for n in names:
            got = plan[n]
            if got is not None and stacked:
                got = (got[0] + 1, got[1] + 1)
            assert (None if got is None else tuple(sorted(got))) == want, \
                (leaf, shape)
    if preset == "gpt-moe-8x410m":
        assert sorted(plan["blocks.0.w_in"]) == [1, 2]
        assert sorted(plan["blocks.0.w_out"]) == [1, 2]
        assert plan["blocks.0.b_in"] is None
        assert plan["blocks.0.router"] is None


# -- gloo ranks ---------------------------------------------------------

def _world(mesh_cfg) -> int:
    return int(np.prod(list(mesh_cfg.values())))


def _sizes(mesh_cfg):
    cfg = MeshConfig(**mesh_cfg).resolve(_world(mesh_cfg))
    return dict(zip(cfg.axis_names, cfg.shape()))


RANK_STEPS = [
    # (mesh, rules, overrides, optimizer): the reference's
    # test_moe_train_step_with_expert_parallelism under both optimizers;
    # the sequence over sp with a capacity that drops.
    pytest.param(dict(dp=2, fsdp=1, tp=1, sp=1, ep=4), "tp_fsdp_rules", {},
                 "adamw", id="dp2-ep4-adamw"),
    pytest.param(dict(dp=2, fsdp=1, tp=1, sp=1, ep=4), "tp_fsdp_rules", {},
                 "adafactor", id="dp2-ep4-adafactor"),
    pytest.param(dict(dp=2, fsdp=1, tp=1, sp=2, ep=2),
                 "context_parallel_rules", {"capacity_factor": 0.5},
                 "adafactor", id="dp2-sp2-ep2-drops-adafactor"),
]
# AdamW divides each element's step by its gradient's RMS, so an element
# whose gradient is within a few eps (1e-8) of 0 moves by a different
# fraction of the learning rate when the gradient's summation order
# changes. An expert's weights take gradients from the few tokens routed to
# it, and some elements come that close. tests/measure_moe_adamw_gap.py
# reads it on this case: the JAX package's own dp2-ep4 step and its
# one-device step differ by up to 1.29e-5 (blocks' wv, 10.9 times the
# bound of tests/test_torch_sharded.py; w_in 5.4e-6, 5.3 times), and the
# port's ranks lie up to 8.7e-6 (7.3 times) from the JAX dp2-ep4 step. Both
# gaps are at most 7.8e-5 of the norm of what the steps changed. So under
# AdamW each block is held to 1e-3 of that norm (chip_smoke.py's
# MICRO_UPDATE_RTOL); Adafactor, which scales by factored moments, is held
# to the bounds of tests/test_torch_sharded.py.
ADAMW_UPDATE_RTOL = 1e-3


@pytest.mark.parametrize("mesh_cfg,rules_name,overrides,opt", RANK_STEPS)
def test_train_step_on_a_mesh_matches_jax(pool, mesh_cfg, rules_name,
                                          overrides, opt):
    cfg = jgpt.config(PRESET, **overrides)
    rules = getattr(jsharding, rules_name)()
    mesh = build_mesh(MeshConfig(**mesh_cfg),
                      devices=jax.devices("cpu")[:_world(mesh_cfg)])
    jopt = OPTIMIZERS[opt](jts)
    batches = _batches(1, seed=1) * 3  # the reference repeats its batch
    with jax.default_matmul_precision("highest"):
        state = jts.init_train_state(cfg, mesh, rules, jopt, seed=0)
        assert "ep" in str(state["params"]["layers"]["w_in"].sharding.spec)
        params0 = jax.tree_util.tree_map(np.array, state["params"])
        cid = pool.submit(
            "gpt_train_step", PRESET, overrides, mesh_cfg, rules_name, opt,
            params0, batches, 1)
        step = jts.make_train_step(cfg, mesh, rules, jopt)
        ref = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            ref.append({k: float(v) for k, v in m.items()})
        params1 = jax.tree_util.tree_map(np.array, state["params"])
    results = pool.result(cid)
    assert ref[-1]["loss"] < ref[0]["loss"]  # learns the batch
    specs, sizes = jgpt.param_specs(cfg, rules), _sizes(mesh_cfg)
    for r in results:
        assert r["step"] == len(batches)
        for got, want in zip(r["metrics"], ref):
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=STEP_RTOL), k
        _check_plain_forward(r)
        _check_blocks(r, params0, specs, sizes, "before")
        if opt == "adafactor":
            _check_blocks(r, params1, specs, sizes, "after",
                          atol=PARAM_ATOL, rtol=STEP_RTOL)
            continue
        for name, got in r["after"].items():
            parts = name.split(".")
            if parts[0] == "blocks":
                leaf, i = parts[2], int(parts[1])
                spec = tuple(specs["layers"][leaf])[1:]
                after, before = (params1["layers"][leaf][i],
                                 params0["layers"][leaf][i])
            else:
                spec, after, before = specs[name], params1[name], \
                    params0[name]
            block = shard_slices(after.shape, spec, sizes, r["coords"])
            change = np.linalg.norm(after[block] - before[block])
            gap = np.linalg.norm(got - after[block])
            assert gap <= ADAMW_UPDATE_RTOL * change, (name, gap, change)


def test_capacity_drops_under_sp_are_one_devices(pool):
    """One MoE layer with its tokens' sequence split over sp=2 (and the
    experts over ep=2, the rows over dp=2): every rank's block of the
    output is the one-device layer's, which drops assignments past
    capacity, and the ranks' shares of the aux term sum to its."""
    mesh_cfg = dict(dp=2, fsdp=1, tp=1, sp=2, ep=2)
    overrides = {"capacity_factor": 0.5}
    params = _params(**overrides)
    h = np.random.default_rng(4).standard_normal(
        (B, S, 64)).astype(np.float32)
    cid = pool.submit("moe_layer", mesh_cfg, "context_parallel_rules",
                      overrides, params, h)
    jcfg = jgpt.config(PRESET, **overrides)
    layer = {k: v[0] for k, v in params["layers"].items()}
    with jax.default_matmul_precision("highest"):
        ref_out, ref_aux = jgpt._moe_ffn(jcfg, jnp.asarray(h), layer)
        probs = jax.nn.softmax(jnp.asarray(h) @ layer["router"])
    # The reference drops: an expert receives more than C assignments.
    C = max(1, int(jcfg.capacity_factor * S * 2 / jcfg.n_experts))
    idx = np.asarray(jax.lax.top_k(probs, 2)[1])
    loads = np.stack([(idx == e).sum((1, 2)) for e in range(4)], -1)
    assert (loads > C).any(), (loads, C)

    model = tgpt.from_jax_params(params, tgpt.config(PRESET, **overrides),
                                 "cpu")
    with torch.no_grad():
        one, one_aux = tgpt._moe_ffn(model.cfg, torch.from_numpy(h),
                                     model.blocks[0])
    np.testing.assert_allclose(one.numpy(), np.asarray(ref_out),
                               atol=LAYER_TOL, rtol=LAYER_TOL)
    np.testing.assert_allclose(float(one_aux), float(ref_aux),
                               rtol=LOSS_RTOL)
    results = pool.result(cid)
    shares = {}
    for r in results:
        rows, cols = slice(*r["rows"]), slice(*r["cols"])
        np.testing.assert_allclose(r["out"], one.numpy()[rows, cols],
                                   atol=LAYER_TOL, rtol=LAYER_TOL)
        shares[(r["coords"]["dp"], r["coords"]["sp"])] = r["aux"]
    assert len(shares) == 4
    np.testing.assert_allclose(sum(shares.values()), float(one_aux),
                               rtol=1e-5)

"""The model zoo under ``context_parallel_rules()`` against the JAX package's
GSPMD runs.

BERT and T5 put their sequence on ``rules.sequence`` (their ``batch_spec``
is ``("batch", "sequence")``), so under ``context_parallel_rules()`` each
rank of an ``sp`` axis holds a block of every row's columns: the port
gathers the keys and values (T5's encoder output too) over ``sp``, takes
global positions (BERT's ``wpe``, T5's relative buckets and causal mask),
counts its loss over the global batch and sums the gradients over ``sp``
(``sharding.average_replicated_grads`` with the model's ``batch_spec``).
BERT's pooler reads position 0, which sp index 0 alone holds: a loss on
it gets its gradient there, summed over the sp ranks' shares.
ViT and the UNet keep their images whole: ``sp`` is a replica axis, every
``sp`` rank holds the same rows and gives the same loss and gradients.

The JAX side runs in this process on the fake CPU devices of
``tests/conftest.py``: the numpy parameters of ``tests/_torch_zoo.py``
placed by the model's ``param_specs`` and the batch by its whole
``batch_spec``, under ``jax.jit`` and "highest" matmul precision. The port
runs on one pool of 4 gloo ranks (``tests/_torch_ranks.py``), each on its
block of the global batch (``collectives.split_by_spec`` by the model's
``batch_spec``), with steps composed as a user composes them; the bounds
are ``tests/test_torch_zoo_mesh.py``'s.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import RankPool
from _torch_zoo import jax_params
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import _common
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.sharding import average_replicated_grads
from test_torch_zoo_mesh import (LR, MODULES, OUT_TOL, STEPS, _hold_steps,
                                 _inputs, _jax_forward, _jax_mesh,
                                 _jax_steps, _place, _place_batch, _sizes,
                                 _unet_draws)

RULES = "context_parallel_rules"
MESHES = {"tp2-sp2": dict(fsdp=1, tp=2, sp=2),
          "dp2-sp2": dict(dp=2, fsdp=1, sp=2)}
B = 4
# BERT's rows hold 16 tokens, 8 on each sp rank; its padding starts at
# these columns, so all of it lies on sp index 1 and every query on index
# 0 must see it there.
BERT_LENGTHS = (16, 13, 10, 9)
# T5: an encoder of 32 and a decoder of 16 tokens, each split over sp.
T5_LENGTHS = (32, 16)


@pytest.fixture(scope="module")
def pool():
    pool = RankPool(4)
    yield pool
    pool.close()


def _sp_inputs(name, seed, lengths=None):
    """(forward inputs, loss batch) of BERT or T5 with B rows, as numpy."""
    rng = np.random.default_rng(seed)
    if name == "bert":
        S = 16 if lengths is None else lengths
        tokens = rng.integers(0, 256, (B, S))
        attn = (np.arange(S)[None] < np.array(BERT_LENGTHS)[:, None]
                ).astype(np.int64)
        masked = (rng.random((B, S))
                  < np.linspace(0.15, 0.6, B)[:, None]).astype(np.float32)
        return (tokens, attn), (tokens, rng.integers(0, 256, (B, S)),
                                masked, attn)
    Se, Sd = T5_LENGTHS if lengths is None else lengths
    enc, dec, tgt = (rng.integers(0, 256, (B, s)) for s in (Se, Sd, Sd))
    mask = (rng.random((B, Sd)) < 0.8).astype(np.float32)
    return (enc, dec), (enc, dec, tgt, mask)


def _jax_rules():
    return jsharding.context_parallel_rules()


CASES = [pytest.param(name, mesh, id=f"{name}-{mesh}")
         for name in ("bert", "t5") for mesh in MESHES]


@pytest.mark.parametrize("name,mesh", CASES)
def test_forward_with_the_sequence_over_sp_matches_jax(pool, name, mesh):
    """BERT's MLM logits and pooler, T5's logits: each rank's block (its
    rows and columns; the pooler's rows, the same on every sp rank)."""
    mesh_cfg = MESHES[mesh]
    jmod, _, preset = MODULES[name]
    cfg = jmod.config(preset)
    params0 = jax_params(jmod, preset)
    inputs, _ = _sp_inputs(name, 0)
    cid = pool.submit("zoo_forward", name, preset, mesh_cfg, RULES, params0,
                      inputs)
    jmesh, jrules = _jax_mesh(mesh_cfg), _jax_rules()
    fns = {"out": _jax_forward(name, jmod, cfg)}
    if name == "bert":
        fns["pooled"] = lambda p, tokens, attn: jmod.pooled(
            p, cfg, tokens, attention_mask=attn)
    with jax.default_matmul_precision("highest"), jmesh:
        params = _place(jmesh, params0, jmod.param_specs(cfg, jrules))
        xs = _place_batch(jmesh, jmod, jrules, inputs)
        want = {k: np.asarray(jax.jit(f)(params, *xs))
                for k, f in fns.items()}
    spec = tuple(jmod.batch_spec(jrules))
    sizes = _sizes(mesh_cfg)
    for r in pool.result(cid):
        for key, whole in want.items():
            # Logits [B, S, V] by (batch, sequence); the pooler's [B, d]
            # by its rows alone.
            block = whole[jsharding.shard_slices(
                whole.shape, spec[:whole.ndim - 1], sizes, r["coords"])]
            assert r[key].shape == block.shape, key
            np.testing.assert_allclose(r[key], block, atol=OUT_TOL,
                                       rtol=OUT_TOL, err_msg=key)


@pytest.mark.parametrize("name,mesh", CASES)
def test_adamw_steps_with_the_sequence_over_sp_match_jax(pool, name, mesh):
    """3 AdamW steps: the global losses and gradient norms, every
    gradient block and the parameters after."""
    mesh_cfg = MESHES[mesh]
    jmod, tmod, preset = MODULES[name]
    cfg = jmod.config(preset)
    params0 = jax_params(jmod, preset)
    batches = [_sp_inputs(name, 10 + i)[1] for i in range(STEPS)]
    cid = pool.submit("zoo_train", name, preset, mesh_cfg, RULES, params0,
                      batches, LR, 0)
    jax_steps = _jax_steps(name, jmod, cfg, _jax_mesh(mesh_cfg), _jax_rules(),
                           params0, batches)
    _hold_steps(pool.result(cid), tmod, params0, _sizes(mesh_cfg), jax_steps)


@pytest.mark.parametrize("name", ["vit", "diffusion"])
def test_sp_is_a_replica_axis_of_vit_and_the_unet(pool, name):
    """One step on dp=2, sp=2: held to the JAX step, and each sp rank's
    loss, gradients and parameters those of its twin at sp index 0."""
    mesh_cfg = MESHES["dp2-sp2"]
    jmod, tmod, preset = MODULES[name]
    cfg = jmod.config(preset)
    params0 = jax_params(jmod, preset)
    batch = _inputs(name, 10, B)[1]
    jax_batch = batch
    if name == "diffusion":
        t, eps = _unet_draws(B, batch[0].shape[1:], 0, cfg.n_timesteps)
        jax_batch = (batch[0], t.astype(np.int32), eps)
    cid = pool.submit("zoo_train", name, preset, mesh_cfg, RULES, params0,
                      [batch], LR, 0)
    results = pool.result(cid)
    _hold_steps(results, tmod, params0, _sizes(mesh_cfg),
                _jax_steps(name, jmod, cfg, _jax_mesh(mesh_cfg),
                           _jax_rules(), params0, [jax_batch]))
    twins = {}
    for r in results:
        assert r["rows"] == (r["coords"]["dp"] * B // 2,
                             (r["coords"]["dp"] + 1) * B // 2)
        twins.setdefault(r["coords"]["dp"], []).append(r)
    for first, second in twins.values():
        assert first["losses"] == second["losses"]
        for key in ("grads", "after"):
            for n, value in first[key].items():
                np.testing.assert_array_equal(second[key][n], value,
                                              err_msg=n)


@pytest.mark.parametrize("name", ["bert", "t5"])
def test_a_sequence_that_does_not_divide_over_sp_raises_in_both_packages(
        pool, name):
    """15 tokens over sp=2: the JAX package's ``device_put`` of the batch
    raises ValueError, and so does the port's placement of it."""
    mesh_cfg = MESHES["dp2-sp2"]
    jmod = MODULES[name][0]
    _, batch = _sp_inputs(name, 0, 15 if name == "bert" else (15, 16))
    with pytest.raises(ValueError, match="divisible by 2"):
        _place_batch(_jax_mesh(mesh_cfg), jmod, _jax_rules(), batch)
    for e in pool.run("zoo_uneven_sequence", name, mesh_cfg, RULES, batch):
        assert e is not None and "size 15 does not split evenly over 2" in e


@pytest.mark.parametrize("name", ["bert", "t5"])
def test_an_sp_of_one_adds_no_operator(pool, name):
    """On dp=4 (sp of one rank) a step under context_parallel_rules()
    dispatches the operators that it dispatches under tp_fsdp_rules(),
    name for name and shape for shape: the split adds no work there."""
    jmod, _, preset = MODULES[name]
    _, batch = _sp_inputs(name, 0)
    for under_tp_fsdp, under_sp in pool.run(
            "zoo_dispatched", name, preset, dict(dp=4, fsdp=1),
            ["tp_fsdp_rules", RULES], jax_params(jmod, preset), batch):
        assert under_tp_fsdp and under_sp == under_tp_fsdp


def test_the_gradient_sum_needs_the_models_batch_spec():
    """The sp sum and the losses' counts take the model's ``batch_spec``
    at every call: none of them guesses it."""
    x = torch.zeros(2, 3)
    for fn, args in ((collectives.batch_layout, ()),
                     (_common.batch_groups, ()), (_common.batch_blocks, ()),
                     (_common.masked_ce, (x, torch.zeros(2, dtype=torch.long),
                                          None)),
                     (average_replicated_grads, ([],))):
        with pytest.raises(TypeError, match="batch_spec"):
            fn(*args)


def test_the_gradient_sum_outside_registered_mesh_raises_on_an_sp_mesh(pool):
    """On dp=2, sp=2, ``average_replicated_grads`` called outside
    ``registered_mesh`` cannot tell whether the sequence was split: it
    raises rather than skip BERT's sum over sp; inside, it returns."""
    for outside, inside in pool.run("zoo_sum_outside_registered_mesh",
                                    MESHES["dp2-sp2"], RULES):
        assert outside is not None and "registered_mesh" in outside
        assert inside


def _pooled_batch(seed):
    """bert-tiny's tokens, a class of its d_model for each row, and
    BERT_LENGTHS' attention mask, as numpy."""
    rng = np.random.default_rng(seed)
    (tokens, attn), _ = _sp_inputs("bert", seed)
    return tokens, rng.integers(0, 64, (B,)), attn


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_a_loss_on_the_pooler_with_the_sequence_over_sp_matches_jax(pool,
                                                                   mesh):
    """3 AdamW steps of a classifier's cross-entropy on BERT's pooler
    (``masked_ce`` with BERT's ``batch_spec``): position 0 lies on sp
    index 0 alone, and every gradient block, the encoder's too, is held
    to ``jax.grad``'s."""
    mesh_cfg = MESHES[mesh]
    jmod, tmod, preset = MODULES["bert"]
    cfg = jmod.config(preset)
    assert cfg.d_model == 64
    params0 = jax_params(jmod, preset)
    batches = [_pooled_batch(20 + i) for i in range(STEPS)]
    cid = pool.submit("zoo_train", "bert-pooled", preset, mesh_cfg, RULES,
                      params0, batches, LR, 0)
    jax_steps = _jax_steps("bert-pooled", jmod, cfg, _jax_mesh(mesh_cfg),
                           _jax_rules(), params0, batches)
    _hold_steps(pool.result(cid), tmod, params0, _sizes(mesh_cfg), jax_steps)

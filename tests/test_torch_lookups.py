"""The port's lookups against ``jnp.take`` and ``jnp.take_along_axis``.

The JAX package takes every embedding row with ``jnp.take`` and every
target logit with ``jnp.take_along_axis``: an id in ``[-n, 0)`` wraps to
``id + n``, an id outside ``[-n, n)`` gives a NaN row (a NaN logit), and
in the gradient a wrapped id adds to its row and an id out of range to
none. The port's helpers (``models/_common.py``: ``embed``, ``ce_stats``,
``masked_ce``; ``models/bert._segment_rows``) are held to them on the ids
``[0, n-1, -1, -n, n, -n-1]``; then the five models that look ids up, with
such ids and targets, against the JAX package at their own tests' bounds;
then GPT and BERT with the vocab split over tp on 2 gloo ranks
(``tests/_torch_ranks.py``) against GSPMD on the same mesh of the fake
CPU devices. NaN is compared as NaN (``assert_array_equal`` and
``assert_allclose`` take equal NaNs as equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import RankPool
from _torch_zoo import (assert_grads_match, flatten, jax_params,
                        jax_value_and_grad)
from ray_tpu.models import bert as jb
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.models import t5 as jt
from ray_tpu.models import vit as jv
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.models import _common
from ray_tpu_torch.models import bert as tb
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import t5 as tt
from ray_tpu_torch.models import vit as tv
from test_torch_sharded import (OPTIMIZERS, PARAM_ATOL, STEP_RTOL,
                                _check_blocks, _sizes, _world)
from test_torch_zoo_mesh import (GRAD_FLOOR, _blocks, _jax_steps, _leaf_of,
                                 _place, _place_batch)
from test_torch_zoo_mesh import GRAD_RTOL as ZOO_GRAD_RTOL

# The helpers alone: the same fp32 values taken, so rows bit-equal;
# gradients and CE sums to fp32 summation order.
HELPER_TOL = 1e-6
# The models: their own tests' bounds (tests/test_torch_gpt.py and the
# zoo's): logits 1e-4, accuracy 1e-6, every gradient 1e-5.
LOGIT_TOL = 1e-4
METRIC_RTOL = 1e-6
GRAD_TOL = 1e-5


def _ids(n):
    """In range, wrapped, and out of range on either side."""
    return np.array([0, n - 1, -1, -n, n, -n - 1])


def _wrapped(n):
    return np.array([0, n - 1, -1, -n])


# -- the helpers ----------------------------------------------------------

def test_embed_follows_jnp_take():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((8, 4)).astype(np.float32)
    ids = _ids(8).reshape(2, 3).astype(np.int32)
    ct = rng.standard_normal((2, 3, 4)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jnp.take(t, ids, axis=0), table)
    t = torch.tensor(table, requires_grad=True)
    got = _common.embed(torch.from_numpy(ids), t)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert np.isnan(got.detach().numpy()[1, 1:]).all()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(ct)[0]),
                               atol=HELPER_TOL, rtol=HELPER_TOL)


def test_segment_rows_follow_jnp_take():
    rng = np.random.default_rng(1)
    table = rng.standard_normal((2, 4)).astype(np.float32)
    ids = _ids(2).reshape(3, 2).astype(np.int32)
    ct = rng.standard_normal((3, 2, 4)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jnp.take(t, ids, axis=0), table)
    t = torch.tensor(table, requires_grad=True)
    got = tb._segment_rows(torch.from_numpy(ids), t)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(ct)[0]),
                               atol=HELPER_TOL, rtol=HELPER_TOL)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_ce_stats_follow_take_along_axis(z_loss):
    """Each target's nll and hit alone (NaN for a target out of range; -1
    never a hit, as jnp.argmax == targets), and the gradient of the sum
    over all six, which is finite: an out-of-range target adds to no
    logit."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, 8)).astype(np.float32)
    logits[2, 7] = 5.0  # the wrapped target -1 of row 2 is its argmax
    targets = _ids(8).astype(np.int32)
    mask = np.ones(6, np.float32)
    for i in range(6):
        want = jgpt._ce_stats(logits[i:i + 1], targets[i:i + 1],
                              mask[i:i + 1], z_loss)
        got = _common.ce_stats(*map(torch.from_numpy,
                                    (logits[i:i + 1], targets[i:i + 1],
                                     mask[i:i + 1])), z_loss)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=HELPER_TOL)
    assert float(_common.ce_stats(*map(torch.from_numpy, (
        logits[2:3], targets[2:3], mask[2:3])))[1]) == 0.0

    def nll_sum(x):
        return jgpt._ce_stats(x, targets, mask, z_loss)[0]
    want_sum, want_grad = jax.value_and_grad(nll_sum)(logits)
    x = torch.tensor(logits, requires_grad=True)
    got_sum, _ = _common.ce_stats(x, torch.from_numpy(targets),
                                  torch.from_numpy(mask), z_loss)
    got_sum.backward()
    assert np.isnan(float(want_sum)) and np.isnan(float(got_sum))
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               atol=HELPER_TOL, rtol=HELPER_TOL)


@pytest.mark.parametrize("pick_log_probs", [False, True])
def test_masked_ce_follows_take_along_axis(pick_log_probs):
    """The zoo's masked mean, with a mask that drops an out-of-range
    target: NaN all the same, as NaN times 0 is NaN in JAX too; the
    gradient finite. T5's and ViT's losses take ``logz`` less the target
    logit, whose logz keeps its gradient at a target out of range; BERT's
    ``mlm_loss`` (``pick_log_probs``) takes the target's entry of the
    log-softmax, which leaves that position none."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 6, 8)).astype(np.float32)
    targets = np.stack([_ids(8), _wrapped(8)[[0, 1, 2, 3, 2, 1]]]).astype(
        np.int32)
    mask = np.ones((2, 6), np.float32)
    mask[0, 4] = 0.0

    def jax_loss(x, t, m):
        if pick_log_probs:
            logp = jax.nn.log_softmax(x, axis=-1)
            nll = -jnp.take_along_axis(logp, t[..., None], -1)[..., 0]
        else:
            nll = (jax.scipy.special.logsumexp(x, axis=-1)
                   - jnp.take_along_axis(x, t[..., None], -1)[..., 0])
        return (nll * m).sum() / jnp.maximum(m.sum(), 1.0)
    for rows in (slice(0, 2), slice(1, 2)):
        want, want_grad = jax.value_and_grad(jax_loss)(
            logits[rows], targets[rows], mask[rows])
        x = torch.tensor(logits[rows], requires_grad=True)
        got, _ = _common.masked_ce(x, torch.from_numpy(targets[rows]),
                                   torch.from_numpy(mask[rows]),
                                   pick_log_probs=pick_log_probs,
                                   batch_spec=tt.batch_spec)
        got.backward()
        np.testing.assert_allclose(float(got), float(want), rtol=HELPER_TOL)
        assert np.isfinite(x.grad.numpy()).all()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                                   atol=HELPER_TOL, rtol=HELPER_TOL)


# -- the models ------------------------------------------------------------

MODELS = {"gpt": (jgpt, tgpt, "gpt-micro"),
          "llama": (jllama, tllama, "llama-micro"),
          "bert": (jb, tb, "bert-tiny"),
          "t5": (jt, tt, "t5-tiny"),
          "vit": (jv, tv, "vit-tiny")}
B, S = 2, 32


def _tokens(n, rng, shape=(B, S), bad=False):
    """Random ids in range with the wrapped ids at a few positions of each
    row; with ``bad`` also the two ids out of range in row 0 (attention
    spreads a NaN row over its sequence: 0 times NaN is NaN)."""
    x = rng.integers(0, n, shape)
    x[0, 3:7] = _wrapped(n)
    x[1, 10:14] = _wrapped(n)
    if bad:
        x[0, 5], x[0, 9] = n, -n - 1
    return x.astype(np.int32)


def _targets(n, rng, shape=(B, S)):
    x = rng.integers(0, n, shape)
    x[0, 2:8] = _ids(n)
    x[1, 1:7] = _ids(n)
    return x.astype(np.int32)


def _loss_batch(name, cfg, seed=0):
    rng = np.random.default_rng(seed)
    if name == "vit":
        images = rng.standard_normal((6, 32, 32, 3)).astype(np.float32)
        return images, _ids(cfg.n_classes).astype(np.int32)
    n = cfg.vocab_size
    if name == "t5":
        return (_tokens(n, rng), _tokens(n, rng, (B, 16)),
                _targets(n, rng, (B, 16)))
    tokens, targets = _tokens(n, rng), _targets(n, rng)
    if name == "bert":
        positions = (rng.random((B, S)) < 0.5).astype(np.float32)
        positions[0, 2:8] = positions[1, 1:7] = 1.0
        attn = np.ones((B, S), np.int32)
        attn[1, 24:] = 0
        return tokens, targets, positions, attn
    return tokens, targets


def _jax_loss(name, jmod, cfg):
    if name == "bert":
        return lambda p, b: (jb.mlm_loss(p, cfg, *b), {})
    if name in ("gpt", "llama"):
        return lambda p, b: jmod.loss_fn(p, cfg, *b, None, z_loss=1e-4)
    return lambda p, b: jmod.loss_fn(p, cfg, *b)


def _port_loss(name, tmod, model, batch):
    xs = [torch.from_numpy(a) for a in batch]
    if name == "bert":
        return tb.mlm_loss(model, *xs), {}
    if name in ("gpt", "llama"):
        return tmod.loss_fn(model, *xs, None, z_loss=1e-4)
    return tmod.loss_fn(model, *xs)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_gradients_match_jax_with_wrapped_ids_and_any_target(
        name):
    """Ids wrapped from [-n, 0) among the tokens, and every target of
    ``_ids``: the loss is NaN in both packages (the targets out of range),
    the accuracy and every gradient finite and the JAX package's."""
    jmod, tmod, preset = MODELS[name]
    cfg = jmod.config(preset)
    params = jax_params(jmod, preset)
    batch = _loss_batch(name, cfg)
    (want, want_m), grads = jax_value_and_grad(_jax_loss(name, jmod, cfg))(
        params, batch)
    model = tmod.from_jax_params(params, tmod.config(preset), "cpu")
    got, got_m = _port_loss(name, tmod, model, batch)
    got.backward()
    assert np.isnan(float(want)) and np.isnan(float(got.detach()))
    if "accuracy" in want_m:
        np.testing.assert_allclose(float(got_m["accuracy"]),
                                   float(want_m["accuracy"]),
                                   rtol=METRIC_RTOL)
    assert_grads_match(model, grads, GRAD_TOL)


def _jax_forward(name, jmod, cfg):
    if name == "bert":
        return lambda p, tokens, segments, attn: jb.mlm_logits(
            p, cfg, tokens, segments, attn)
    return lambda p, *x: jmod.forward(p, cfg, *x)


def _forward_inputs(name, n, seed=1):
    rng = np.random.default_rng(seed)
    if name == "t5":
        return _tokens(n, rng, bad=True), _tokens(n, rng, (B, 16), bad=True)
    tokens = _tokens(n, rng, bad=True)
    if name != "bert":
        return (tokens,)
    # Row 1 reads its segment rows through wrapped ids.
    segments = np.zeros((B, S), np.int32)
    segments[1, 16:] = -1
    segments[1, :4] = -2
    return tokens, segments, np.ones((B, S), np.int32)


@pytest.mark.parametrize("name", ["bert", "gpt", "llama", "t5"])
def test_logits_match_jax_with_ids_out_of_range(name):
    """Tokens with wrapped ids, and ids out of range in row 0: NaN logits
    where the JAX package gives them (row 0), the rest within the models'
    bound."""
    jmod, tmod, preset = MODELS[name]
    cfg = jmod.config(preset)
    params = jax_params(jmod, preset)
    inputs = _forward_inputs(name, cfg.vocab_size)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(_jax_forward(name, jmod, cfg))(params,
                                                                 *inputs))
    model = tmod.from_jax_params(params, tmod.config(preset), "cpu")
    fwd = tb.mlm_logits if name == "bert" else (
        tt.forward if name == "t5" else (lambda m, x: m(x)))
    with torch.no_grad():
        got = fwd(model, *map(torch.from_numpy, inputs)).float().numpy()
    assert np.isnan(want).any() and not np.isnan(want).all()
    np.testing.assert_allclose(got, want.astype(np.float32), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


# -- the vocab over tp on gloo ranks ---------------------------------------

@pytest.fixture(scope="module")
def pool():
    pool = RankPool(2)
    yield pool
    pool.close()


TP_MESH = dict(tp=2)


def test_vocab_parallel_stats_follow_jax_over_the_whole_vocab(pool):
    """The target logit, logsumexp and hits of a vocab split over 2 ranks
    against jnp on the whole vocab: every target of ``_ids``, a row whose
    largest logit is a tie across the blocks, rows holding NaN in one
    block or both (``jnp.argmax`` takes the first NaN: a hit for target 0
    on a row that is all NaN, never for a target out of range)."""
    rng = np.random.default_rng(7)
    n = 8
    logits = rng.standard_normal((10, n)).astype(np.float32)
    targets = np.concatenate([_ids(n), [1, 5, 0, 2]]).astype(np.int32)
    logits[6, [1, 5]] = 4.0  # a tie across the two blocks: the first wins
    logits[7, 5] = np.nan  # NaN in the second block only
    logits[8] = np.nan  # NaN everywhere: argmax 0
    logits[9, [2, 6]] = np.nan  # NaN in both blocks: the first, 2
    logz = jax.scipy.special.logsumexp(logits, axis=-1)
    tgt = jnp.take_along_axis(logits, targets[:, None], -1)[:, 0]
    hits = jnp.argmax(logits, -1) == targets
    assert np.asarray(hits)[6:].all()
    for got in pool.run("vocab_stats", logits, targets):
        np.testing.assert_allclose(got[0], np.asarray(logz), rtol=1e-6)
        np.testing.assert_array_equal(got[1], np.asarray(tgt))
        np.testing.assert_array_equal(got[2], np.asarray(hits))


def _jax_mesh(mesh_cfg):
    return build_mesh(MeshConfig(**mesh_cfg),
                      devices=jax.devices("cpu")[:_world(mesh_cfg)])


def test_gpt_with_the_vocab_over_tp_matches_jax(pool):
    """gpt-micro's vocab (the embedding and the head) split over tp=2: a
    train step on wrapped tokens and every target, and logits of tokens
    out of range, against GSPMD on the same mesh."""
    cfg = jgpt.config("gpt-micro")
    rules = jsharding.tp_fsdp_rules()
    mesh = _jax_mesh(TP_MESH)
    jopt = OPTIMIZERS["adamw"](jts)
    rng = np.random.default_rng(5)
    n = cfg.vocab_size
    batches = [{"tokens": _tokens(n, rng, (4, S)),
                "targets": _targets(n, rng, (4, S))}]
    bad = _forward_inputs("gpt", n)[0]
    with jax.default_matmul_precision("highest"):
        state = jts.init_train_state(cfg, mesh, rules, jopt, seed=0)
        params0 = jax.tree_util.tree_map(np.asarray, state["params"])
        step_id = pool.submit("gpt_train_step", "gpt-micro", {}, TP_MESH,
                              "tp_fsdp_rules", "adamw", params0, batches, 1)
        fwd_id = pool.submit("gpt_forward", "gpt-micro", {}, TP_MESH,
                             "tp_fsdp_rules", params0, bad)
        logits = np.asarray(jax.jit(jgpt.forward, static_argnums=1)(
            state["params"], cfg, bad))
        step = jts.make_train_step(cfg, mesh, rules, jopt)
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in batches[0].items()})
        ref = {k: float(v) for k, v in m.items()}
        params1 = jax.tree_util.tree_map(np.asarray, state["params"])
    assert np.isnan(ref["loss"]) and np.isfinite(ref["accuracy"])
    specs, sizes = jgpt.param_specs(cfg, rules), _sizes(TP_MESH)
    for r in pool.result(step_id):
        for k, want in ref.items():
            assert r["metrics"][0][k] == pytest.approx(
                want, rel=STEP_RTOL, nan_ok=True), k
        _check_blocks(r, params1, specs, sizes, "after", atol=PARAM_ATOL,
                      rtol=STEP_RTOL)
    assert np.isnan(logits).any() and not np.isnan(logits).all()
    for r in pool.result(fwd_id):
        np.testing.assert_allclose(r["logits"], logits, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_bert_with_the_vocab_over_tp_matches_jax(pool):
    """bert-tiny's tied vocab split over tp=2: one AdamW step's loss (NaN
    in both), gradients and update on wrapped tokens and every target,
    against GSPMD on the same mesh (tests/test_torch_zoo_mesh.py's
    bounds), and the MLM logits of tokens out of range."""
    mesh_cfg, rules = TP_MESH, "tp_fsdp_rules"
    cfg = jb.config("bert-tiny")
    params0 = jax_params(jb, "bert-tiny")
    batch = _loss_batch("bert", cfg, seed=6)
    inputs = _forward_inputs("bert", cfg.vocab_size)
    fwd_inputs = (inputs[0], inputs[2])  # the rank case's (tokens, attn)
    train_id = pool.submit("zoo_train", "bert", "bert-tiny", mesh_cfg, rules,
                           params0, [batch], 1e-3, 0)
    fwd_id = pool.submit("zoo_forward", "bert", "bert-tiny", mesh_cfg, rules,
                         params0, fwd_inputs)
    mesh, jrules = _jax_mesh(mesh_cfg), getattr(jsharding, rules)()
    losses, norms, grads, _, _, specs = _jax_steps(
        "bert", jb, cfg, mesh, jrules, params0, [batch])
    with jax.default_matmul_precision("highest"), mesh:
        want = np.asarray(jax.jit(lambda p, t, a: jb.mlm_logits(
            p, cfg, t, attention_mask=a))(
                _place(mesh, params0, specs),
                *_place_batch(mesh, jb, jrules, fwd_inputs)))
    assert np.isnan(losses).all() and np.isfinite(norms).all()
    leaf_of = _leaf_of(tb, params0)
    sizes = _sizes(mesh_cfg)
    leaf_norms = {k: float(np.linalg.norm(g))
                  for k, g in flatten(grads).items()}
    floor = GRAD_FLOOR * max(leaf_norms.values())
    for r in pool.result(train_id):
        assert np.isnan(r["losses"]).all()
        np.testing.assert_allclose(r["norms"], norms, rtol=STEP_RTOL)
        for n, got, block in _blocks(r, grads, specs, sizes, leaf_of,
                                     "grads"):
            bound = ZOO_GRAD_RTOL * max(leaf_norms[leaf_of[n][0]], floor)
            assert np.linalg.norm(got - block) <= bound, (n, bound)
    assert np.isnan(want).any() and not np.isnan(want).all()
    for r in pool.result(fwd_id):
        start, stop = r["rows"]
        np.testing.assert_allclose(r["out"], want[start:stop],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)

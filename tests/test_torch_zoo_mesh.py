"""The model zoo on a mesh of gloo ranks against the JAX package's GSPMD runs.

ViT, BERT and T5 under DTensor tensor parallelism and FSDP2, and the
diffusion UNet data-parallel, each placed through its ``from_jax_params``
(or ``init``) with ``mesh=`` and ``rules=``. The JAX side runs in this
process: the same numpy parameters (``tests/_torch_zoo.py``) placed by
``shard_tree`` under the model's ``param_specs`` on the 8 fake CPU
devices of ``tests/conftest.py``, the batch by its ``batch_spec``, under
``jax.jit`` and "highest" matmul precision. The port's side runs on
spawned gloo ranks of the same mesh shape (``tests/_torch_ranks.py``: one
pool of 8 ranks and one of 4 for the module), each on its rows of the
global batch; a step is composed as a user composes it, inside
``registered_mesh``: the loss, backward, ``average_replicated_grads``,
the port's AdamW at weight decay 0 (optax.adam's arithmetic).

Every rank returns its blocks of the outputs, gradients and parameters;
the test holds each to the block that the JAX ``PartitionSpec`` gives the
rank's mesh position (``shard_slices``) of the JAX result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding

from _torch_ranks import RankPool
from _torch_zoo import SMALL_GRAD, UPDATE_RTOL, flatten, jax_params
from ray_tpu.models import bert as jb
from ray_tpu.models import diffusion as jd
from ray_tpu.models import t5 as jt
from ray_tpu.models import vit as jv
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import _params
from ray_tpu_torch.models import bert as tb
from ray_tpu_torch.models import diffusion as td
from ray_tpu_torch.models import t5 as tt
from ray_tpu_torch.models import vit as tv
from ray_tpu_torch.parallel.sharding import shard_slices

# The models' fp32 bounds (tests/test_torch_{vit,bert,t5,diffusion}.py):
# outputs and losses to summation order, 1e-5; each gradient block to
# 1e-5 of its JAX leaf's norm. ViT's sharded forward keeps the bound of
# the JAX package's own test (tests/test_models.py's
# test_vit_sharded_forward).
OUT_TOL = 1e-5
VIT_FWD_TOL = 2e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
# A leaf whose gradient is small beside the others is held to 1e-5 of
# this share of the model's largest leaf gradient norm: BERT's query and
# key weights and biases get ~1e-3 of the others' (the softmax's backward
# cancels), and even without a mesh the port's differ from JAX's by
# 1.5-2e-5 of their own norm on this test's batch; the key bias's is
# rounding alone (the softmax ignores a shift every key shares).
GRAD_FLOOR = 1e-2
LR, STEPS = 1e-3, 3

MODULES = {"vit": (jv, tv, "vit-tiny"), "bert": (jb, tb, "bert-tiny"),
           "t5": (jt, tt, "t5-tiny"), "diffusion": (jd, td, "unet-tiny")}
# ViT as the JAX package's test places it (batch over dp, heads and MLP
# over tp, classes whole), and with its 10 classes over tp too.
VIT_RULES = dict(batch="dp", embed=None, vocab=None)
VIT_TP_RULES = dict(batch="dp", embed=None)

CONFIGS = {
    "vit": ("vit", dict(dp=4, tp=2), VIT_RULES),
    "vit-classes-tp": ("vit", dict(dp=4, tp=2), VIT_TP_RULES),
    "t5": ("t5", dict(fsdp=2, tp=2), "tp_fsdp_rules"),
    "bert": ("bert", dict(dp=2, fsdp=2, tp=2), "tp_fsdp_rules"),
    "unet-dp": ("diffusion", dict(dp=4, fsdp=1), "dp_rules"),
    "unet-fsdp": ("diffusion", dict(dp=1, fsdp=4), "fsdp_rules"),
}


@pytest.fixture(scope="module")
def pools():
    pools = {8: RankPool(8), 4: RankPool(4)}
    yield pools
    for pool in pools.values():
        pool.close()


def _world(mesh_cfg) -> int:
    return int(np.prod(list(mesh_cfg.values())))


def _sizes(mesh_cfg):
    cfg = MeshConfig(**mesh_cfg).resolve(_world(mesh_cfg))
    return dict(zip(cfg.axis_names, cfg.shape()))


def _jax_rules(rules):
    return (getattr(jsharding, rules)() if isinstance(rules, str)
            else jsharding.ShardingRules(**rules))


def _jax_mesh(mesh_cfg):
    return build_mesh(MeshConfig(**mesh_cfg),
                      devices=jax.devices("cpu")[:_world(mesh_cfg)])


def _place(mesh, tree, specs):
    return jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree, specs,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _place_batch(mesh, jmod, rules, arrays):
    """Each array placed by the model's batch_spec (its first ``ndim``
    entries): its rows over the rules' batch axes and, for BERT's and
    T5's under ``rules.sequence``, its columns over sp."""
    spec = jmod.batch_spec(rules)
    return tuple(jax.device_put(a, NamedSharding(
        mesh, jax.sharding.PartitionSpec(*spec[:np.ndim(a)])))
        for a in arrays)


def _inputs(name, seed, B):
    """(forward inputs, loss batch) of the model's test, as numpy."""
    rng = np.random.default_rng(seed)
    if name == "vit":
        images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
        return (images,), (images, rng.integers(0, 10, (B,)))
    if name == "bert":
        tokens = rng.integers(0, 256, (B, 16))
        # Padding from a different column in each row, and masked
        # positions kept from 10% to 60% of each row: every rank masks a
        # different count.
        attn = (np.arange(16)[None] < np.linspace(16, 9, B).astype(int)[:,
                None]).astype(np.int64)
        keep = np.linspace(0.1, 0.6, B)[:, None]
        masked = (rng.random((B, 16)) < keep).astype(np.float32)
        return (tokens, attn), (tokens, rng.integers(0, 256, (B, 16)),
                                masked, attn)
    if name == "t5":
        enc, dec, tgt = (rng.integers(0, 256, (B, s)) for s in (12, 8, 8))
        return (enc, dec), (enc, dec, tgt)
    images = (rng.standard_normal((B, 16, 16, 3)) * 0.5).astype(np.float32)
    t = rng.integers(0, 50, (B,)).astype(np.int64)
    return (images, t), (images,)


def _jax_forward(name, jmod, cfg):
    if name == "bert":
        return lambda p, tokens, attn: jmod.mlm_logits(
            p, cfg, tokens, attention_mask=attn)
    return lambda p, *x: jmod.forward(p, cfg, *x)


def _unet_draws(B, shape, seed, T):
    """The t and eps that the port's loss_fn draws for the global batch
    from a generator seeded with ``seed``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, T, (B,), generator=g)
    eps = torch.randn((B,) + tuple(shape), generator=g, dtype=torch.float32)
    return t.numpy(), eps.numpy()


def _jax_loss(name, jmod, cfg):
    """The JAX package's loss of a (placed) batch → (loss, aux)."""
    if name == "bert":
        return lambda p, b: (jmod.mlm_loss(p, cfg, *b), {})
    if name == "bert-pooled":
        # A classifier's loss on the pooler's outputs as logits.
        def pooled_ce(p, b):
            tokens, labels, attn = b
            logp = jax.nn.log_softmax(
                jmod.pooled(p, cfg, tokens, attention_mask=attn), axis=-1)
            return -jnp.take_along_axis(logp, labels[:, None], -1).mean(), {}
        return pooled_ce
    if name != "diffusion":
        return lambda p, b: jmod.loss_fn(p, cfg, *b)

    def unet_loss(p, b):
        # loss_fn's arithmetic with the port's draws of t and eps.
        images, t, eps = b
        _, alphas_bar = jmod.make_schedule(cfg)
        ab = alphas_bar[t][:, None, None, None]
        x_t = jnp.sqrt(ab) * images + jnp.sqrt(1 - ab) * eps
        pred = jmod.forward(p, cfg, x_t, t)
        return ((pred - eps) ** 2).mean(), {}
    return unet_loss


def _leaf_of(tmod, params0):
    """{port parameter name: (JAX leaf key, layer index or None)}."""
    model = tmod.from_jax_params(params0, tmod.config(
        {tv: "vit-tiny", tb: "bert-tiny", tt: "t5-tiny",
         td: "unet-tiny"}[tmod]), "cpu")
    out = {}
    for key, names in _params.leaf_groups(model).items():
        layered = _params.stacked(key, names)
        out.update((n, (key, i if layered else None))
                   for i, n in enumerate(names))
    return out


def _blocks(result, params, specs, sizes, leaf_of, key):
    """(name, the rank's block, the JAX tree's block) of every tensor."""
    for name, got in result[key].items():
        leaf, layer = leaf_of[name]
        whole, spec = _params.lookup(params, leaf), tuple(
            _params.lookup(specs, leaf))
        if layer is not None:
            whole, spec = whole[layer], spec[1:]
        want = whole[shard_slices(whole.shape, spec, sizes,
                                  result["coords"])]
        assert got.shape == want.shape, (name, got.shape, want.shape)
        yield name, got, want


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_forward_matches_jax_on_the_same_mesh(pools, config):
    name, mesh_cfg, rules = CONFIGS[config]
    jmod, tmod, preset = MODULES[name]
    cfg = jmod.config(preset)
    params0 = jax_params(jmod, preset)
    inputs, _ = _inputs(name, 0, 8)
    cid = pools[_world(mesh_cfg)].submit("zoo_forward", name, preset,
                                         mesh_cfg, rules, params0, inputs)
    mesh, jrules = _jax_mesh(mesh_cfg), _jax_rules(rules)
    specs = jmod.param_specs(cfg, jrules)
    with jax.default_matmul_precision("highest"), mesh:
        want = np.asarray(jax.jit(_jax_forward(name, jmod, cfg))(
            _place(mesh, params0, specs),
            *_place_batch(mesh, jmod, jrules, inputs)))
    tol = VIT_FWD_TOL if name == "vit" else OUT_TOL
    leaf_of = _leaf_of(tmod, params0)
    for r in pools[_world(mesh_cfg)].result(cid):
        start, stop = r["rows"]
        np.testing.assert_allclose(r["out"], want[start:stop], atol=tol,
                                   rtol=OUT_TOL)
        # The weights on the mesh are the JAX placement's blocks exactly.
        for n, got, block in _blocks(r, params0, specs, _sizes(mesh_cfg),
                                     leaf_of, "params"):
            np.testing.assert_array_equal(got, block, err_msg=n)


def _jax_steps(name, jmod, cfg, mesh, jrules, params0, batches):
    """optax.adam steps on the JAX mesh, one per batch → (losses, the
    gradients' global norms, the first gradients, the parameters after,
    per leaf where any gradient came within SMALL_GRAD of 0, the
    specs)."""
    specs = jmod.param_specs(cfg, jrules)
    opt = optax.adam(LR)
    loss_fn = _jax_loss(name, jmod, cfg)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    @jax.jit
    def update(params, state, grads):
        updates, state = opt.update(grads, state, params)
        return (optax.apply_updates(params, updates), state,
                optax.global_norm(grads))

    with jax.default_matmul_precision("highest"), mesh:
        params = _place(mesh, params0, specs)
        state, losses, first, small = opt.init(params), [], None, {}
        norms = []
        for b in batches:
            (loss, _), grads = value_and_grad(
                params, _place_batch(mesh, jmod, jrules, b))
            params, state, norm = update(params, state, grads)
            losses.append(float(loss))
            norms.append(float(norm))
            grads = jax.tree_util.tree_map(np.asarray, grads)
            first = first or grads
            for leaf, g in flatten(grads).items():
                small[leaf] = small.get(leaf, False) | (
                    np.abs(g) < SMALL_GRAD)
    small = _params.nest({k: [k] for k in small}, lambda k, _: small[k])
    return (losses, norms, first, jax.tree_util.tree_map(np.asarray, params),
            small, specs)


def _train_batches(name, cfg):
    """The global batches of the steps (the UNet's with its t and eps, as
    the port's generator draws them for step i from seed i)."""
    batches = [_inputs(name, 10 + i, 8)[1] for i in range(STEPS)]
    if name != "diffusion":
        return batches, batches
    jax_batches = []
    for i, (images,) in enumerate(batches):
        t, eps = _unet_draws(8, images.shape[1:], i, cfg.n_timesteps)
        jax_batches.append((images, t.astype(np.int32), eps))
    return batches, jax_batches


def _check_update(name, got, want, p0, small):
    """The zoo's bound of 3 Adam steps (tests/_torch_zoo.py): each block to
    UPDATE_RTOL of its change's norm, an element whose gradient came near
    0 to the most Adam moves one."""
    diff = got - want
    still = want == p0
    assert np.all(diff[still] == 0), name
    keep = ~small
    assert np.all(np.abs(diff[~keep]) <= LR * STEPS), name
    if keep.any():
        moved = np.linalg.norm((want - p0)[keep])
        err = np.linalg.norm(diff[keep]) / max(moved, 1e-30)
        assert err <= UPDATE_RTOL, (name, err)


# ViT's steps with its classes over tp too (the vocab-parallel CE).
@pytest.mark.parametrize("config", sorted(set(CONFIGS) - {"vit"}))
def test_gradients_and_adamw_steps_match_jax(pools, config):
    name, mesh_cfg, rules = CONFIGS[config]
    jmod, tmod, preset = MODULES[name]
    cfg = jmod.config(preset)
    params0 = jax_params(jmod, preset)
    batches, jax_batches = _train_batches(name, cfg)
    sizes = _sizes(mesh_cfg)
    if name == "bert":
        # Each rank's mean over its own masked positions, averaged over
        # the data ranks, divides its sum by blocks x its count; GSPMD's
        # mean by the global count. They differ on every step's batch.
        blocks = sizes["dp"] * sizes["fsdp"]
        for b in batches:
            counts = b[2].reshape(blocks, -1).sum(1)
            assert np.any(counts * blocks != counts.sum()), counts
    cid = pools[_world(mesh_cfg)].submit("zoo_train", name, preset, mesh_cfg,
                                         rules, params0, batches, LR, 0)
    mesh, jrules = _jax_mesh(mesh_cfg), _jax_rules(rules)
    _hold_steps(pools[_world(mesh_cfg)].result(cid), tmod, params0, sizes,
                _jax_steps(name, jmod, cfg, mesh, jrules, params0,
                           jax_batches))


def _hold_steps(results, tmod, params0, sizes, jax_steps):
    """Each rank's losses, global gradient norms, first gradients' blocks
    and parameters after the steps (``zoo_train``) held to the JAX
    package's steps (``_jax_steps``) on a mesh of ``sizes``."""
    losses, global_norms, grads, after, small, specs = jax_steps
    norms = {leaf: float(np.linalg.norm(g))
             for leaf, g in flatten(grads).items()}
    floor = GRAD_FLOOR * max(norms.values())
    leaf_of = _leaf_of(tmod, params0)
    for r in results:
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
        # optim's global sums weigh each block by its mesh's copies: the
        # norm over the placed leaves (those outside FSDP2 too) is JAX's.
        np.testing.assert_allclose(r["norms"], global_norms, rtol=LOSS_RTOL)
        for n, got, want in _blocks(r, grads, specs, sizes, leaf_of,
                                    "grads"):
            bound = GRAD_RTOL * max(norms[leaf_of[n][0]], floor)
            assert np.linalg.norm(got - want) <= bound, (n, bound)
        p0 = {n: w for n, _, w in _blocks(r, params0, specs, sizes,
                                          leaf_of, "after")}
        sm = {n: w for n, _, w in _blocks(r, small, specs, sizes, leaf_of,
                                          "after")}
        for n, got, want in _blocks(r, after, specs, sizes, leaf_of,
                                    "after"):
            _check_update(n, got, want, p0[n], sm[n])


@pytest.mark.parametrize("world,config", [(8, "bert"), (4, "t5"),
                                          (8, "vit-classes-tp"),
                                          (4, "unet-fsdp")])
def test_init_on_a_mesh_holds_the_one_device_weights(pools, world, config):
    """The same seed gives every rank its block of the weights that init
    draws without a mesh."""
    name, mesh_cfg, rules = CONFIGS[config]
    _, tmod, preset = MODULES[name]
    names = pools[world].run("zoo_seeded_init", name, preset, mesh_cfg,
                             rules, 3)
    model = tmod.from_jax_params(jax_params(MODULES[name][0], preset),
                                 tmod.config(preset), "cpu")
    want = [n for n, _ in model.named_parameters()]
    assert all(n == want for n in names)


def test_limits_raise(pools):
    """What the port does not place raises, never computes something
    else: a mesh axis that does not divide a dim (vit-tiny's 10 classes
    over tp=4), the stacked layer axis over pp. (BERT's and T5's sequence
    over sp computes: tests/test_torch_zoo_sp.py.)"""
    errors = pools[4].run("zoo_errors", dict(fsdp=1, tp=4))
    for e in errors:
        assert set(e) == {"classes", "layers"}
        assert "does not divide over tp=4" in e["classes"]
        assert "item 12" in e["layers"]


def test_an_uneven_vocab_raises_in_both_packages(pools):
    """bert-tiny with a vocab of 30 over tp=4 (fsdp=2): the JAX package's
    placement (``shard_tree``, ``jax.device_put``) raises ValueError, and
    so does the port's: GSPMD pads no uneven parameter here."""
    mesh_cfg = dict(fsdp=2, tp=4)
    cfg = jb.config("bert-tiny", vocab_size=30)
    rules = jsharding.tp_fsdp_rules()
    params = jax_params(jb, "bert-tiny", vocab_size=30)
    with pytest.raises(ValueError, match="divisible by 4"):
        jsharding.shard_tree(params, _jax_mesh(mesh_cfg),
                             jb.param_specs(cfg, rules))
    for e in pools[8].run("zoo_uneven_vocab", mesh_cfg, "tp_fsdp_rules"):
        assert e is not None and "does not divide over tp=4" in e, e

"""The port's RLlib new stack (``ray_tpu_torch.rllib.core``) against the
JAX package's.

``tests/test_rllib_core.py``'s 6 cases by name, on the port: the module's
forwards, the learner group's remote mode on the port's runtime, and its
local mode on a ``dp`` mesh of 2 gloo ranks (``tests/_torch_ranks.py``),
where the JAX learner shards its batch over 2 fake CPU devices. Then the
port held to the JAX package from the same parameters (the JAX module's
init carried over as its numpy tree): the forwards, one
``Learner.update``, remote against local gradients, the dp learner's
updates (a ragged batch trimmed as in JAX), and the reading of the action
space without gymnasium. Everything runs on the CPU (``device="cpu"``).
"""

import collections

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from _torch_ranks import RankPool
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.rllib import core as jcore
from ray_tpu_torch.rllib.core import (LearnerConfig, LearnerGroup,
                                      MLPActorCriticModule, PPOLearner,
                                      RLModuleSpec)
from ray_tpu_torch.rllib.core.learner_group import learner_options
from ray_tpu_torch.rllib.policy.torch_policy import (action_dims,
                                                     as_tensor,
                                                     from_jax_params)

# fp32 forwards and gradients of the same parameters: summation order.
FWD_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# Weights after Adam steps from gradients equal to GRAD_RTOL (Adam divides
# by |g|, so the bound grows with the steps): one update, and the dp
# learner's 11.
STEP_ATOL = 1e-6
DP_STEPS_ATOL = 1e-5


def _spaces(discrete=True):
    obs_space = gym.spaces.Box(-1, 1, (4,), np.float32)
    act_space = (gym.spaces.Discrete(2) if discrete
                 else gym.spaces.Box(-1, 1, (2,), np.float32))
    return obs_space, act_space


def _spec(discrete=True):
    return RLModuleSpec(MLPActorCriticModule, *_spaces(discrete),
                        {"fcnet_hiddens": (16,)})


def _jspec(discrete=True):
    return jcore.RLModuleSpec(jcore.MLPActorCriticModule, *_spaces(discrete),
                              {"fcnet_hiddens": (16,)})


def _ppo_batch(n=64, seed=0, act_dim=2, discrete=True):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": (rng.integers(0, 2, size=n) if discrete
                    else rng.normal(size=(n, act_dim)).astype(np.float32)),
        "logp_old": np.full(n, -0.69, np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    }


def _jax_params(discrete=True, seed=0):
    """The JAX module's initial parameters, as their numpy tree."""
    params = _jspec(discrete).build().init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _assert_trees(got, want, rtol, atol):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The learner's small products on one thread: with torch's default
    pool of a thread per core, the other test processes on the host make
    each update wait at the pool's barriers (one PPO iteration 8 s
    instead of 0.5 s). Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def port_cluster():
    ray_tpu_torch.shutdown()
    ctx = ray_tpu_torch.init(num_cpus=8, num_gpus=0, _memory=1e9)
    yield ctx
    ray_tpu_torch.shutdown()


# -- tests/test_rllib_core.py's cases --------------------------------------

def test_rl_module_forwards():
    module = _spec().build()
    params = module.init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: as_tensor(v, "cpu") for k, v in _ppo_batch(8).items()}
    out = module.forward_train(params, batch)
    assert out["logits"].shape == (8, 2)
    assert out["values"].shape == (8,)
    assert out["logp"].shape == (8,)
    actions, extras = module.forward_exploration(
        params, batch["obs"], torch.Generator().manual_seed(1))
    assert actions.shape == (8,)
    assert extras["values"].shape == (8,)
    greedy = module.forward_inference(params, batch["obs"])
    assert greedy.shape == (8,)
    # continuous variant
    module_c = _spec(discrete=False).build()
    params_c = module_c.init(torch.Generator().manual_seed(2), "cpu")
    a, _ = module_c.forward_exploration(
        params_c, batch["obs"], torch.Generator().manual_seed(3))
    assert a.shape == (8, 2)


# The dp learner on 2 gloo ranks against the JAX learner with its batch
# over 2 fake CPU devices: 10 updates of a 64-row batch, then one of 67
# rows (67 % 2 = 1 row dropped); a batch of 1 row cannot be split.
SPMD_LR = 5e-3
SPMD_BATCHES = [_ppo_batch(64, seed=2)] * 10 + [_ppo_batch(67, seed=9)]


@pytest.fixture(scope="module")
def spmd():
    """The port's ranks and the JAX learner from the same parameters."""
    params0 = _jax_params(seed=1)
    pool = RankPool(2)
    try:
        ranks = pool.run("rllib_learner", params0, SPMD_BATCHES, SPMD_LR, 1)
    finally:
        pool.close()
    mesh = build_mesh(MeshConfig(dp=2, fsdp=1), devices=jax.devices()[:2])
    group = jcore.LearnerGroup(jcore.PPOLearner, _jspec(),
                               jcore.LearnerConfig(lr=SPMD_LR), mesh=mesh)
    group.set_weights(params0)
    metrics, dropped = [], []
    for batch in SPMD_BATCHES:
        metrics.append(group.update(batch))
        dropped.append(group._learner.last_dropped_rows)
    with pytest.raises(ValueError, match="cannot be sharded") as err:
        group.update({k: v[:1] for k, v in SPMD_BATCHES[0].items()})
    return ranks, {"metrics": metrics, "dropped": dropped,
                   "weights": group.get_weights(), "error": str(err.value)}


def test_learner_spmd_update_decreases_loss(spmd):
    ranks, _ = spmd
    for got in ranks:
        assert got["dp"] == 2
        m0, m = got["metrics"][0], got["metrics"][9]
        assert np.isfinite(m["total_loss"])
        assert m["total_loss"] < m0["total_loss"]
        assert "pi" in got["weights"] and "vf" in got["weights"]


def test_learner_batch_sharding_metadata(spmd):
    """Each rank takes its block of the batch's rows (1/2 of them)."""
    ranks, _ = spmd
    obs = SPMD_BATCHES[0]["obs"]
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(got["rows"],
                                      obs[rank * 32:(rank + 1) * 32])


def test_learner_spmd_ragged_batch_trims(spmd):
    """Non-divisible batches train on the largest splittable prefix;
    too-small batches fail with the JAX package's error."""
    ranks, want = spmd
    for got in ranks:
        assert got["dropped"] == [0] * 10 + [1] == want["dropped"]
        assert np.isfinite(got["metrics"][-1]["total_loss"])
        assert got["error"] == want["error"]


def test_learner_group_remote_matches_full_batch_gradient(port_cluster):
    """Averaging per-shard gradients over 2 remote learners equals the
    full-batch gradient, so remote-DP and a single learner walk the same
    trajectory."""
    batch = _ppo_batch(64, seed=3)
    config = LearnerConfig(lr=1e-2, seed=7, device="cpu")
    remote = LearnerGroup(PPOLearner, _spec(), config,
                          num_remote_learners=2)
    assert remote.is_remote
    local = PPOLearner(_spec(), config).build()
    # identical init (same seed) -> identical weights after one update
    m_remote = remote.update(batch)
    local.update(batch)
    assert np.isfinite(m_remote["total_loss"])
    w_r = remote.get_weights()
    w_l = local.get_weights()
    np.testing.assert_allclose(
        w_r["pi"][0]["w"], w_l["pi"][0]["w"], rtol=1e-4, atol=1e-5)
    # weight broadcast keeps the fleet in sync
    remote.set_weights(w_l)
    np.testing.assert_allclose(remote.get_weights()["vf"][0]["w"],
                               w_l["vf"][0]["w"], rtol=1e-6)
    remote.stop()


def test_learner_group_remote_ragged_and_tiny_batches(port_cluster):
    """Uneven shards are weighted so no learner sees an empty batch and
    every row contributes once."""
    config = LearnerConfig(lr=1e-2, seed=11, device="cpu")
    remote = LearnerGroup(PPOLearner, _spec(), config,
                          num_remote_learners=3)
    local = PPOLearner(_spec(), config).build()
    batch = _ppo_batch(65, seed=12)  # 65 rows over 3 learners: 22/22/21
    m = remote.update(batch)
    assert np.isfinite(m["total_loss"])
    local.update(batch)
    np.testing.assert_allclose(remote.get_weights()["pi"][0]["w"],
                               local.get_weights()["pi"][0]["w"],
                               rtol=1e-4, atol=1e-5)
    # fewer rows than learners: only populated shards dispatch
    m2 = remote.update(_ppo_batch(2, seed=13))
    assert np.isfinite(m2["total_loss"])
    remote.stop()


# -- held to the JAX package ----------------------------------------------

@pytest.mark.parametrize("discrete", [True, False],
                         ids=["discrete", "box"])
def test_module_forwards_match_jax(discrete):
    """logits, values, logp and entropy of the same parameters, and the
    greedy actions."""
    params = _jax_params(discrete, seed=4)
    batch = _ppo_batch(32, seed=5, discrete=discrete)
    jmodule = _jspec(discrete).build()
    want = jmodule.forward_train(params, batch)
    module = _spec(discrete).build()
    tparams = from_jax_params(params, "cpu")
    tbatch = {k: as_tensor(v, "cpu") for k, v in batch.items()}
    got = module.forward_train(tparams, tbatch)
    for key in ("logits", "values", "logp", "entropy"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=key)
    np.testing.assert_allclose(
        module.forward_inference(tparams, tbatch["obs"]).detach().numpy(),
        np.asarray(jmodule.forward_inference(params, batch["obs"])),
        rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("discrete", [True, False],
                         ids=["discrete", "box"])
def test_one_learner_update_matches_jax(discrete):
    """The gradients of the same batch, then one clipped Adam step: the
    metrics and the weights after it."""
    params = _jax_params(discrete, seed=6)
    batch = _ppo_batch(64, seed=7, discrete=discrete)
    lr = 1e-2
    jlearner = jcore.PPOLearner(
        _jspec(discrete), jcore.LearnerConfig(lr=lr, grad_clip=0.5)).build()
    jlearner.set_weights(params)
    learner = PPOLearner(
        _spec(discrete),
        LearnerConfig(lr=lr, grad_clip=0.5, device="cpu")).build()
    learner.set_weights(params)
    want_g, want_m = jlearner.compute_gradients(batch)
    got_g, got_m = learner.compute_gradients(batch)
    _assert_trees(got_g, want_g, GRAD_RTOL, GRAD_ATOL)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=k)
    want_u = jlearner.update(batch)
    got_u = learner.update(batch)
    assert set(got_u) == set(want_u)
    for k in want_u:
        np.testing.assert_allclose(got_u[k], want_u[k], rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=k)
    _assert_trees(learner.get_weights(), jlearner.get_weights(), FWD_TOL,
                  STEP_ATOL)


def test_remote_and_local_gradients_are_equal(port_cluster):
    """A remote learner's gradients of a batch are the local learner's,
    and its update lands on the same weights."""
    batch = _ppo_batch(48, seed=8)
    config = LearnerConfig(lr=1e-3, seed=3, device="cpu")
    local = PPOLearner(_spec(), config).build()
    remote = LearnerGroup(PPOLearner, _spec(), config,
                          num_remote_learners=1)
    got = ray_tpu_torch.get(
        remote._learners[0].compute_gradients.remote(batch))
    want = local.compute_gradients(batch)
    _assert_trees(got[0], want[0], 0, 0)
    assert got[1] == want[1]
    remote.update(batch)
    local.update(batch)
    _assert_trees(remote.get_weights(), local.get_weights(), 0, 0)
    remote.stop()


class _CardProbe:
    def gpu_ids(self):
        return ray_tpu_torch.get_gpu_ids()


@pytest.mark.parametrize("cards,learners,share", [
    (1, 1, 1.0), (1, 2, 0.5), (1, 3, 1 / 3), (2, 3, 0.5)])
def test_learners_on_the_card_share_the_clusters_gpus(cards, learners,
                                                      share):
    """Learners on the card lease a card each while there are cards
    enough, else an equal share of one: on a fake cluster of ``cards``
    GPUs all ``learners`` actors are placed at once and every GPU is
    leased (a whole card each would leave the second of two learners on
    one card waiting for ever). A learner on the CPU leases nothing."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, num_gpus=cards, _memory=1e9)
    try:
        options = learner_options(None, learners)
        assert options == {"num_gpus": pytest.approx(share)}
        assert learner_options("cpu", learners) == {}
        probe = ray_tpu_torch.remote(_CardProbe).options(**options)
        actors = [probe.remote() for _ in range(learners)]
        ids = ray_tpu_torch.get([a.gpu_ids.remote() for a in actors],
                                timeout=60)
        # One card each, and no card holding more than its share allows.
        assert all(len(card) == 1 for card in ids)
        per_card = collections.Counter(card[0] for card in ids)
        assert max(per_card.values()) * share <= 1 + 1e-9
        # The runtime counts resources in units of 1e-4.
        assert ray_tpu_torch.available_resources().get("GPU", 0) == \
            pytest.approx(cards - learners * share, abs=1e-3)
        for a in actors:
            ray_tpu_torch.kill(a)
    finally:
        ray_tpu_torch.shutdown()


def test_learners_on_the_card_need_a_gpu_in_the_cluster(port_cluster):
    with pytest.raises(ValueError, match="no GPU"):
        learner_options(None, 2)
    assert learner_options("cpu", 2) == {}


def test_dp_learner_matches_the_jax_learner_on_a_2_device_mesh(spmd):
    """Every update's metrics and the weights after 11 updates (the last
    one ragged) equal the JAX learner's, and the ranks' replicas agree."""
    ranks, want = spmd
    for got in ranks:
        for g, w in zip(got["metrics"], want["metrics"]):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                           atol=1e-5, err_msg=k)
        _assert_trees(got["weights"], want["weights"], 1e-4, DP_STEPS_ATOL)
    _assert_trees(ranks[0]["weights"], ranks[1]["weights"], 0, 0)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["pixels", "float"])
def test_the_catalog_cnn_and_an_image_policy_match_jax(dtype):
    """The catalog's CNN encoder (strided "SAME" convolutions on NHWC, the
    NHWC flatten, the head) and an image observation's actor-critic
    policy from the JAX package's parameters: the features, logits and
    values."""
    from ray_tpu.rllib.models.catalog import ModelCatalog as JCatalog
    from ray_tpu.rllib.policy import make_policy as jmake_policy
    from ray_tpu_torch.rllib.models.catalog import ModelCatalog
    from ray_tpu_torch.rllib.policy import make_policy

    high = 255 if dtype == np.uint8 else 1.0
    space = gym.spaces.Box(0, high, (15, 13, 3), dtype)
    config = {"conv_filters": [[8, 4, 2], [16, 3, 2], [8, 3, 1]],
              "post_fcnet_dim": 32}
    rng = np.random.default_rng(3)
    obs = (rng.integers(0, 256, (5, 15, 13, 3)) if dtype == np.uint8
           else rng.random((5, 15, 13, 3))).astype(dtype)
    jinit, japply, jfeat = JCatalog.get_encoder(space, config)
    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0)))
    _, apply, feat = ModelCatalog.get_encoder(space, config)
    assert feat == jfeat
    np.testing.assert_allclose(
        apply(from_jax_params(params, "cpu"),
              as_tensor(obs, "cpu")).detach().numpy(),
        np.asarray(japply(params, obs)), rtol=FWD_TOL, atol=FWD_TOL)
    jpol = jmake_policy(config, space, gym.spaces.Discrete(4), seed=1)
    pol = make_policy(config, space, gym.spaces.Discrete(4), seed=1,
                      device="cpu")
    pol.set_weights(jpol.get_weights())
    tobs = as_tensor(obs, "cpu")
    for got, want in ((pol.logits(pol.params, tobs),
                       jpol.logits(jpol.params, obs)),
                      (pol._value(pol.params, tobs),
                       jpol._value(jpol.params, obs))):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)


def test_the_space_reading_needs_no_gymnasium():
    """``action_dims`` reads a space's attributes as the JAX package reads
    ``isinstance(space, gym.spaces.Discrete)``: Discrete, Box and
    MultiBinary (which has ``n`` but is not discrete)."""
    for space in (gym.spaces.Discrete(5), gym.spaces.Discrete(2, start=1),
                  gym.spaces.Box(-1, 1, (3,), np.float32),
                  gym.spaces.Box(-1, 1, (2, 3), np.float32),
                  gym.spaces.MultiBinary(4)):
        jm = jcore.MLPActorCriticModule(gym.spaces.Box(-1, 1, (4,)), space)
        assert action_dims(space) == (jm.discrete, jm.act_dim), space
        tm = MLPActorCriticModule(gym.spaces.Box(-1, 1, (4,)), space)
        assert (tm.discrete, tm.act_dim) == (jm.discrete, jm.act_dim)
    # Any object with the same attributes reads the same.

    class Space:
        pass

    d, b = Space(), Space()
    d.n, d.shape = 3, ()
    b.shape = (2, 2)
    assert action_dims(d) == (True, 3)
    assert action_dims(b) == (False, 4)

"""Selective remat on a mesh of gloo ranks against the JAX package's step.

``remat_policy="selective"`` runs the same non-reentrant checkpoint on the
mesh as without one (``models/gpt.py`` ``_remat_block``): FSDP2's hooks and
DTensor see an ordinary forward and backward, and the backward's recompute
takes back the block's projections and K1's (out, lse). The JAX side runs
in this process on the 8 fake CPU devices of ``tests/conftest.py`` with
the same policy (``save_only_these_names``), under "highest" matmul
precision; the port's side runs on spawned gloo ranks
(``tests/_torch_ranks.py``: a pool of 8 and one of 2 for the module), and
each rank's parameter blocks are held to the JAX step's
(``tests/test_torch_sharded.py``'s helpers and bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ranks import RankPool
from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu.parallel import train_step as jts
from test_torch_sharded import (OPTIMIZERS, PARAM_ATOL, STEP_RTOL,
                                _check_blocks, _check_plain_forward, _sizes,
                                _world)

SELECTIVE = {"remat": True, "remat_policy": "selective"}


@pytest.fixture(scope="module")
def pools():
    pools = {8: RankPool(8), 2: RankPool(2)}
    yield pools
    for pool in pools.values():
        pool.close()


def _batches(vocab, B, S, n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (B, S), dtype=np.int32),
             "targets": rng.integers(0, vocab, (B, S), dtype=np.int32)}
            for _ in range(n)]


CASES = [
    # (preset, overrides, mesh, rules, optimizer, accum, B, S)
    pytest.param("gpt-micro", {"attn_impl": "flash"},
                 dict(dp=2, fsdp=2, tp=2), "tp_fsdp_rules", "adamw", 1, 8,
                 128, id="gpt-micro-dp2-fsdp2-tp2-flash-adamw"),
    pytest.param("gpt-micro", {"attn_impl": "flash"}, dict(dp=1, fsdp=2),
                 "fsdp_rules", "adafactor", 2, 8, 128,
                 id="gpt-micro-fsdp2-flash-adafactor-accum2"),
    pytest.param("gpt-moe-tiny", {}, dict(dp=2, fsdp=1, tp=1, sp=1, ep=4),
                 "tp_fsdp_rules", "adafactor", 1, 4, 32,
                 id="gpt-moe-tiny-dp2-ep4-adafactor"),
    # Adafactor: under AdamW one wte element of this case lies 5.9e-6
    # from the JAX step's, the same under "selective", "full" and no remat
    # (AdamW divides each element's step by its gradient's RMS; see
    # tests/test_torch_moe.py's ADAMW_UPDATE_RTOL).
    pytest.param("gpt-micro", {"attn_impl": "ring"},
                 dict(dp=1, fsdp=1, tp=1, sp=2), "context_parallel_rules",
                 "adafactor", 1, 4, 64, id="gpt-micro-sp2-ring-adafactor"),
]


@pytest.mark.parametrize("preset,overrides,mesh_cfg,rules_name,opt,accum,B,S",
                         CASES)
def test_selective_train_step_matches_jax_on_the_same_mesh(
        pools, preset, overrides, mesh_cfg, rules_name, opt, accum, B, S):
    opts = dict(overrides, **SELECTIVE)
    cfg = jgpt.config(preset, **opts)
    rules = getattr(jsharding, rules_name)()
    mesh = build_mesh(MeshConfig(**mesh_cfg),
                      devices=jax.devices("cpu")[:_world(mesh_cfg)])
    jopt = OPTIMIZERS[opt](jts)
    batches = _batches(cfg.vocab_size, B, S, 2)
    pool = pools[_world(mesh_cfg)]
    with jax.default_matmul_precision("highest"):
        state = jts.init_train_state(cfg, mesh, rules, jopt, seed=0)
        params0 = jax.tree_util.tree_map(np.asarray, state["params"])
        cid = pool.submit("gpt_train_step", preset, opts, mesh_cfg,
                          rules_name, opt, params0, batches, accum)
        step = jts.make_train_step(cfg, mesh, rules, jopt,
                                   accum_steps=accum)
        ref = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            ref.append({k: float(v) for k, v in m.items()})
        params1 = jax.tree_util.tree_map(np.asarray, state["params"])
    specs, sizes = jgpt.param_specs(cfg, rules), _sizes(mesh_cfg)
    for r in pool.result(cid):
        assert r["step"] == len(batches)
        for got, want in zip(r["metrics"], ref):
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=STEP_RTOL), k
        _check_blocks(r, params0, specs, sizes, "before")
        _check_plain_forward(r)
        _check_blocks(r, params1, specs, sizes, "after", atol=PARAM_ATOL,
                      rtol=STEP_RTOL)


@pytest.mark.parametrize("preset,overrides,mesh_cfg,rules_name", [
    pytest.param("gpt-micro", {"attn_impl": "flash"},
                 dict(dp=2, fsdp=2, tp=2), "tp_fsdp_rules",
                 id="gpt-micro-dp2-fsdp2-tp2-flash"),
    pytest.param("gpt-moe-tiny", {}, dict(dp=2, fsdp=1, tp=1, sp=1, ep=4),
                 "tp_fsdp_rules", id="gpt-moe-tiny-dp2-ep4"),
])
def test_selective_gradients_are_full_remats_on_the_mesh(
        pools, preset, overrides, mesh_cfg, rules_name):
    """Every rank's sharded gradient after one backward under "selective"
    is the one under "full", bit for bit: the kept outputs are the values
    the recompute would give, and the collectives (FSDP2's, tp's, the MoE
    layer's over ep) run in the same order on every rank. The flash
    forward (K1's plain version here) runs once per layer under
    "selective", twice under "full"."""
    cfg = jgpt.config(preset)
    params0 = jax.tree_util.tree_map(
        np.asarray, jgpt.init(cfg, jax.random.PRNGKey(1)))
    batch = _batches(cfg.vocab_size, 8, 128 if preset == "gpt-micro" else 32,
                     1, seed=4)[0]
    results = pools[_world(mesh_cfg)].run("remat_grads", preset, overrides,
                                          mesh_cfg, rules_name, params0,
                                          batch)
    flash = overrides.get("attn_impl") == "flash"
    for r in results:
        assert r["k1_runs"] == {"full": 2 * cfg.n_layers * flash,
                                "selective": cfg.n_layers * flash}
        assert sorted(r["full"]) == sorted(r["selective"])
        for name, g in r["full"].items():
            np.testing.assert_array_equal(r["selective"][name], g,
                                          err_msg=name)


@pytest.mark.parametrize("remat, grad, blocks_keeping", [
    (True, True, "all"), (True, False, "none"), (False, True, "none")],
    ids=["remat-grad", "remat-no-grad", "no-remat-grad"])
def test_selective_keeps_values_only_in_its_checkpoint(remat, grad,
                                                       blocks_keeping,
                                                       monkeypatch):
    """A selective config keeps values only in the checkpoint that
    ``_remat_block`` wraps around each block while gradients are recorded
    (one ``_Kept`` a block). With remat off, or under ``no_grad`` (eval,
    serving), no block opens one, the projections and K1 run plain, and
    the logits are full remat's, bit for bit; nothing stays current after
    the forward."""
    import torch

    from ray_tpu_torch.models import gpt as tgpt
    opened = []
    contexts = tgpt._Kept.contexts
    monkeypatch.setattr(tgpt._Kept, "contexts", classmethod(
        lambda cls: opened.append(1) or contexts()))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (2, 128)))
    logits = {}
    for policy in ("selective", "full"):
        cfg = tgpt.config("gpt-tiny", attn_impl="flash", remat=remat,
                          remat_policy=policy)
        model = tgpt.init(cfg, torch.Generator().manual_seed(0), "cpu")
        with torch.set_grad_enabled(grad):
            logits[policy] = model(tokens)
        assert tgpt._KEPT is None
    assert len(opened) == (cfg.n_layers if blocks_keeping == "all" else 0)
    assert torch.equal(logits["selective"], logits["full"])

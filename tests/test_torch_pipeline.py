"""The port's GPipe pipeline (``parallel/pipeline.py``) against the JAX
package's, on gloo ranks.

The cases of ``tests/test_parallel_extra.py:82-130``: a tanh stage
pipelined over ``pp`` on the port's mesh of 8 gloo ranks
(``tests/_torch_ranks.py``) against the JAX package's
``make_pipeline_fn`` and ``sequential_apply`` on its 8 fake CPU devices,
forward and gradients; the stage parameters placed by
``stage_param_specs`` (each rank's gradient is its stage's block) or
whole (each rank's gradient is the whole one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import RankPool
from ray_tpu.parallel import (MeshConfig, build_mesh, make_pipeline_fn,
                              sequential_apply, stage_param_specs)
from ray_tpu.parallel.sharding import tree_shardings
from ray_tpu_torch.parallel import pipeline as tpipeline

# tests/test_parallel_extra.py's bounds.
FWD_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def pool():
    pool = RankPool(8)
    yield pool
    pool.close()


def _jax_stage(params, x):
    y = x @ params["w"]
    return jnp.tanh(y + params["b"] if "b" in params else y)


def _torch_stage(params, x):
    y = x @ params["w"]
    return torch.tanh(y + params["b"] if "b" in params else y)


def _inputs(n_stages, n_micro, mb, dim, bias, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((n_stages, dim, dim)) * 0.3)
              .astype(np.float32)}
    if bias:
        params["b"] = (rng.standard_normal((n_stages, dim)) * 0.1
                       ).astype(np.float32)
    xs = rng.standard_normal((n_micro, mb, dim)).astype(np.float32)
    return params, xs


def _jax_mesh(**kw):
    return build_mesh(MeshConfig(fsdp=1, tp=1, sp=1, ep=1, **kw),
                      devices=jax.devices("cpu")[:8])


@pytest.mark.parametrize("placed", [True, False], ids=["placed", "whole"])
def test_pipeline_matches_sequential(pool, placed):
    mesh_cfg = dict(dp=2, fsdp=1, tp=1, sp=1, ep=1, pp=4)
    params, xs = _inputs(4, 8, 2, 16, bias=True)
    cid = pool.submit("pipeline_run", mesh_cfg, params, xs, placed)
    mesh = _jax_mesh(dp=2, pp=4)
    sharded = jax.device_put(params, tree_shardings(
        mesh, stage_param_specs(params)))
    out_pipe = np.asarray(jax.jit(make_pipeline_fn(_jax_stage, 4, mesh))(
        sharded, xs))
    out_seq = np.asarray(sequential_apply(_jax_stage, params, xs))
    np.testing.assert_allclose(out_pipe, out_seq, rtol=FWD_TOL, atol=FWD_TOL)
    for r in pool.result(cid):
        np.testing.assert_allclose(r["out"], out_seq, rtol=FWD_TOL,
                                   atol=FWD_TOL)


@pytest.mark.parametrize("placed", [True, False], ids=["placed", "whole"])
def test_pipeline_gradients_flow(pool, placed):
    """Each stage's gradient once: the masked sum that replicates the
    output passes the gradient through, so it is not multiplied by pp."""
    mesh_cfg = dict(dp=4, fsdp=1, tp=1, sp=1, ep=1, pp=2)
    params, xs = _inputs(2, 4, 2, 8, bias=False, seed=1)
    cid = pool.submit("pipeline_run", mesh_cfg, params, xs, placed)
    mesh = _jax_mesh(dp=4, pp=2)
    pipelined = make_pipeline_fn(_jax_stage, 2, mesh)
    g_pipe = jax.jit(jax.grad(
        lambda p: (pipelined(p, xs) ** 2).sum()))(params)
    g_seq = jax.grad(
        lambda p: (sequential_apply(_jax_stage, p, xs) ** 2).sum())(params)
    np.testing.assert_allclose(np.asarray(g_pipe["w"]),
                               np.asarray(g_seq["w"]), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    want = np.asarray(g_seq["w"])
    stages = set()
    for r in pool.result(cid):
        stage = r["coords"]["pp"]
        stages.add(stage)
        got = r["grads"]["w"]
        np.testing.assert_allclose(got, want[stage:stage + 1] if placed
                                   else want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    assert stages == {0, 1}


def test_pipeline_refuses_a_wrong_stage_count_or_no_pp_axis(pool):
    for errors in pool.run("pipeline_errors",
                           dict(dp=2, fsdp=1, tp=1, sp=1, ep=1, pp=4)):
        assert "must equal" in errors[0]
        assert "no 'pp' axis" in errors[1]


def test_sequential_apply_matches_jax():
    params, xs = _inputs(3, 5, 2, 8, bias=True, seed=2)
    want = np.asarray(sequential_apply(_jax_stage, params, xs))
    got = tpipeline.sequential_apply(
        _torch_stage, {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    specs = tpipeline.stage_param_specs({"a": 0, "n": {"b": 1}})
    assert tuple(specs["a"]) == ("pp",) and tuple(specs["n"]["b"]) == ("pp",)

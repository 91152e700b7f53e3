"""How far AdamW's parameters after 3 steps of gpt-moe-tiny lie apart
between two layouts of the same step, on the CPU: a one-off measurement,
not a test.

The case is ``tests/test_torch_moe.py``'s ``dp2-ep4-adamw``: the same
weights, batch and optimizer. It prints, per parameter, the largest
element gap between

* the JAX package's step on the dp2-ep4 mesh of 8 fake CPU devices and
  its step on one device, and
* each of 8 gloo ranks of the port's step on dp2-ep4 and its block of the
  JAX dp2-ep4 step,

each beside its ratio to the bound of ``tests/test_torch_sharded.py``
(``atol + rtol * |want|``, 1e-6 and 1e-5; a ratio above 1 breaks it) and
the norm of the gap over the norm of what the steps changed (the bound
``tests/test_torch_moe.py`` holds AdamW's blocks to is 1e-3). Run
from the repo root (~1 min):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/measure_moe_adamw_gap.py
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_ranks import RankPool  # noqa: E402
from ray_tpu.models import gpt as jgpt  # noqa: E402
from ray_tpu.parallel import MeshConfig, build_mesh  # noqa: E402
from ray_tpu.parallel import sharding as jsharding  # noqa: E402
from ray_tpu.parallel import train_step as jts  # noqa: E402
from ray_tpu_torch.parallel.sharding import shard_slices  # noqa: E402
from test_torch_moe import OPTIMIZERS, PRESET, _batches  # noqa: E402
from test_torch_sharded import PARAM_ATOL, STEP_RTOL  # noqa: E402

MESH = dict(dp=2, fsdp=1, tp=1, sp=1, ep=4)
ONE = dict(dp=1, fsdp=1, tp=1, sp=1, ep=1)


def _jax_steps(mesh_cfg, batches):
    """(params before, params after) of the JAX step on ``mesh_cfg``."""
    n = int(np.prod(list(mesh_cfg.values())))
    mesh = build_mesh(MeshConfig(**mesh_cfg), devices=jax.devices("cpu")[:n])
    cfg, rules = jgpt.config(PRESET), jsharding.tp_fsdp_rules()
    jopt = OPTIMIZERS["adamw"](jts)
    with jax.default_matmul_precision("highest"):
        state = jts.init_train_state(cfg, mesh, rules, jopt, seed=0)
        before = jax.tree_util.tree_map(np.array, state["params"])
        step = jts.make_train_step(cfg, mesh, rules, jopt)
        for b in batches:
            state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        return before, jax.tree_util.tree_map(np.array, state["params"])


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _gap(got, want, before):
    d = np.abs(got - want)
    return (float(d.max()),
            float((d / (PARAM_ATOL + STEP_RTOL * np.abs(want))).max()),
            float(np.linalg.norm(d) / np.linalg.norm(want - before)))


def _line(name, gap, ratio, rel):
    print(f"  {name:16s} max|gap| {gap:.3e}  / bound {ratio:7.3f}  "
          f"|gap|/|change| {rel:.2e}")


def main():
    batches = _batches(1, seed=1) * 3
    mesh_before, mesh_after = _jax_steps(MESH, batches)
    one_before, one_after = _jax_steps(ONE, batches)
    for (name, a), (_, b) in zip(_leaves(mesh_before), _leaves(one_before)):
        assert np.array_equal(a, b), name
    print("JAX dp2-ep4 against JAX one device, after 3 AdamW steps:")
    for (name, a), (_, b), (_, a0) in zip(_leaves(mesh_after),
                                          _leaves(one_after),
                                          _leaves(mesh_before)):
        _line(name, *_gap(a, b, a0))

    pool = RankPool(8)
    try:
        results = pool.run("gpt_train_step", PRESET, {}, MESH,
                           "tp_fsdp_rules", "adamw", mesh_before, batches, 1)
    finally:
        pool.close()
    specs = jgpt.param_specs(jgpt.config(PRESET), jsharding.tp_fsdp_rules())
    sizes = dict(zip(MeshConfig(**MESH).resolve(8).axis_names,
                     MeshConfig(**MESH).resolve(8).shape()))
    worst = {}
    for r in results:
        for name, got in r["after"].items():
            parts = name.split(".")
            if parts[0] == "blocks":
                leaf, i = parts[2], int(parts[1])
                spec = tuple(specs["layers"][leaf])[1:]
                whole, start = (mesh_after["layers"][leaf][i],
                                mesh_before["layers"][leaf][i])
                key = f"layers/{leaf}"
            else:
                spec, whole, start, key = (specs[name], mesh_after[name],
                                           mesh_before[name], name)
            block = shard_slices(whole.shape, spec, sizes, r["coords"])
            new = _gap(got, whole[block], start[block])
            worst[key] = tuple(max(a, b) for a, b in
                               zip(worst.get(key, (0.0,) * 3), new))
    print("port dp2-ep4 (8 gloo ranks) against JAX dp2-ep4, after 3 AdamW "
          "steps, worst rank and layer:")
    for key in sorted(worst):
        _line(key, *worst[key])


if __name__ == "__main__":
    main()

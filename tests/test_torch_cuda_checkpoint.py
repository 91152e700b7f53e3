"""The port's train state saved on the card and restored on the CPU.

Needs a CUDA card (marker ``cuda``) and skips where there is none. The
file imports neither JAX nor ``ray_tpu``, so it runs on a host that has
only PyTorch, with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py \
        tests/test_torch_cuda_checkpoint.py

gpt-micro takes 2 steps on the card (flash attention: K1-K3), is saved
with ``save_train_state``, and is restored into a state on the CPU built
from another seed: every parameter, moment, count and the step equal the
card's bit for bit.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt
from ray_tpu_torch.parallel import optim
from ray_tpu_torch.parallel import train_step as ts
from ray_tpu_torch.train import (CheckpointManager, latest_checkpoint,
                                 restore_train_state, save_train_state)

pytestmark = pytest.mark.cuda

OPTIMIZERS = {"adamw": lambda: ts.default_optimizer(1e-3, warmup_steps=1),
              "adafactor": lambda: ts.memory_efficient_optimizer(
                  1e-2, warmup_steps=1)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _flat(state):
    """The state in the JAX layout, on the CPU, by path."""
    model = state["params"]
    groups = gpt.leaf_groups(model)
    out = {f"params/{k}": v for k, v in _walk(optim.to_jax_tree(
        dict(model.named_parameters()), groups, "cpu"))}
    out.update((f"opt_state/{k}", v) for k, v in _walk(
        optim.to_optax_state(state["opt_state"], groups, "cpu")))
    out["step"] = state["step"].cpu()
    return out


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_gpt_micro_saved_on_the_card_restores_on_the_cpu(cuda, tmp_path,
                                                         opt_name):
    cfg = gpt.config("gpt-micro", attn_impl="flash")
    opt = OPTIMIZERS[opt_name]()
    state = ts.init_train_state(cfg, optimizer=opt, seed=0, device=cuda)
    step = ts.make_train_step(cfg, optimizer=opt)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 129))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(cuda),
             "targets": torch.from_numpy(toks[:, 1:]).to(cuda)}
    for _ in range(2):
        state, _ = step(state, batch)
    manager = CheckpointManager(str(tmp_path), "card")
    assert save_train_state(state, manager) is not None

    cpu = ts.init_train_state(cfg, optimizer=opt, seed=1, device="cpu")
    cpu = restore_train_state(cpu, latest_checkpoint(manager))
    want, got = _flat(state), _flat(cpu)
    assert set(got) == set(want) and len(got) > 30
    for path, w in want.items():
        assert got[path].device.type == "cpu"
        assert got[path].dtype == w.dtype and torch.equal(got[path], w), path
    assert int(cpu["step"]) == 2

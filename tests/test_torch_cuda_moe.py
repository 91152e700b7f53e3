"""The port's MoE GPT and its mesh paths on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips where there
is none; the file imports neither JAX nor ``ray_tpu``:

    python -m pytest --noconftest -q tests/test_torch_cuda_moe.py

gpt-moe-tiny (fp32, 4 experts, top-2, head dim 16) through K1-K3 on the
card against its run on the CPU through the plain versions; the same
model's train step on a 1-rank NCCL mesh with the experts over an ``ep``
of one against the step without a mesh; and ring and Ulysses attention
over an ``sp`` of one against dot attention.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt
from ray_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# fp32 sums in different orders (tests/test_torch_gpt.py's bound; the
# gradients' is each tensor's difference over its norm).
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def nccl_mesh(cuda):
    from ray_tpu_torch.parallel import MeshConfig
    from ray_tpu_torch.train.torch import prepare_mesh
    mesh = prepare_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1, ep=1))
    try:
        yield mesh
    finally:
        torch.distributed.destroy_process_group()


def _batch(cfg, seed, device="cpu"):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, cfg.max_seq_len + 1)))
    return {"tokens": toks[:, :-1].to(device),
            "targets": toks[:, 1:].to(device)}


def test_gpt_moe_tiny_on_the_card_matches_the_cpu(cuda):
    cfg = gpt.config("gpt-moe-tiny", attn_impl="flash")
    cpu = gpt.init(cfg, torch.Generator().manual_seed(0), "cpu")
    card = gpt.GPT(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    b = _batch(cfg, 1)
    with torch.no_grad():
        ref, ref_aux = cpu.forward_with_aux(b["tokens"])
        before = fa.launches
        got, got_aux = card.forward_with_aux(b["tokens"].to(cuda))
        assert fa.launches - before == cfg.n_layers
    torch.testing.assert_close(got.cpu(), ref, atol=TOL, rtol=TOL)
    torch.testing.assert_close(got_aux.cpu(), ref_aux, atol=0, rtol=TOL)
    gpt.loss_fn(cpu, b["tokens"], b["targets"])[0].backward()
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    gpt.loss_fn(card, b["tokens"].to(cuda),
                b["targets"].to(cuda))[0].backward()
    torch.cuda.synchronize()
    assert (fa.launches - before[0], fa.dq_launches - before[1],
            fa.dkv_launches - before[2]) == (cfg.n_layers,) * 3
    for (name, p), (_, q) in zip(card.named_parameters(),
                                 cpu.named_parameters()):
        err = float((p.grad.cpu() - q.grad).norm() / q.grad.norm())
        assert err <= TOL, (name, err)


def test_moe_mesh_step_with_experts_over_ep_matches_the_step_without(
        nccl_mesh):
    """gpt-moe-tiny's train step on the 1-rank mesh under tp_fsdp_rules
    (experts a DTensor over (tp, ep)) against the step without a mesh from
    the same seed: 3 Adafactor steps, bit-equal (one rank runs the same
    ops; a group of one sends nothing)."""
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel import train_step as ts
    cfg = gpt.config("gpt-moe-tiny", attn_impl="flash")
    rules = sharding.tp_fsdp_rules()
    opt = lambda: ts.memory_efficient_optimizer(1e-2, warmup_steps=1)
    plain = ts.init_train_state(cfg, optimizer=opt(), seed=0)
    placed = ts.init_train_state(cfg, nccl_mesh, rules, opt(), seed=0)
    w_in = dict(placed["params"].named_parameters())["blocks.0.w_in"]
    assert w_in.device_mesh.mesh_dim_names == ("dp", "fsdp", "tp", "ep")
    steps = (ts.make_train_step(cfg, optimizer=opt()),
             ts.make_train_step(cfg, nccl_mesh, rules, opt()))
    for i in range(3):
        batch = _batch(cfg, 10 + i, "cuda")
        plain, m_plain = steps[0](plain, batch)
        placed, m_placed = steps[1](placed, batch)
        assert float(m_placed["loss"]) == float(m_plain["loss"])
    for (name, p), (_, ref) in zip(placed["params"].named_parameters(),
                                   plain["params"].named_parameters()):
        assert torch.equal(sharding.local(p), ref), name


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_attention_over_an_sp_of_one(nccl_mesh, impl):
    """gpt-micro (fp32) placed by context_parallel_rules on the 1-rank
    mesh: ring and Ulysses attention against dot attention, launching no
    flash kernel."""
    from dataclasses import replace

    from ray_tpu_torch.parallel import context_parallel_rules
    from ray_tpu_torch.parallel.mesh import registered_mesh
    cfg = gpt.config("gpt-micro", attn_impl="dot")
    rules = context_parallel_rules()
    model = gpt.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                     "cuda", mesh=nccl_mesh, rules=rules)
    tokens = _batch(cfg, 2, "cuda")["tokens"]
    with registered_mesh(nccl_mesh, rules), torch.no_grad():
        want = model(tokens)
        model.reshard()
        model.cfg = replace(cfg, attn_impl=impl)
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        got = model(tokens)
        model.reshard()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)

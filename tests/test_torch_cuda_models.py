"""The model zoo's ports on the card against the CPU.

Every test here needs a CUDA card (marker ``cuda``) and skips where there
is none; the file imports neither JAX nor ``ray_tpu``:

    python -m pytest --noconftest -q tests/test_torch_cuda_models.py

unet-tiny, vit-tiny, bert-tiny and t5-tiny in fp32 (TF32 off): the same
seeded weights and inputs on the card and on the CPU, the forward, the
loss and its gradients, and unet-tiny's 10-step DDIM sample.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import bert, diffusion, t5, vit

pytestmark = pytest.mark.cuda

# fp32 sums in different orders: the bound of the CPU parity tests'
# logits (tests/test_torch_{vit,bert,t5}.py); gradients as each tensor's
# difference over its norm, or over GRAD_FLOOR of the largest tensor's
# where its own is smaller: BERT's bk has a zero gradient but for rounding
# (softmax ignores a shift that every key shares), so its norm is noise.
TOL = 1e-4
GRAD_FLOOR = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pair(module, preset, cuda):
    cfg = module.config(preset)
    cpu = module.init(cfg, torch.Generator().manual_seed(0), "cpu")
    card = type(cpu)(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _to(batch, device):
    return [x.to(device) for x in batch]


def _batch(preset, seed=0):
    """(loss_fn arguments after the model) of each tiny preset."""
    g = torch.Generator().manual_seed(seed)
    if preset == "unet-tiny":
        return [torch.randn((2, 16, 16, 3), generator=g),
                torch.randint(0, 50, (2,), generator=g),
                torch.randn((2, 16, 16, 3), generator=g)]
    if preset == "vit-tiny":
        return [torch.randn((2, 32, 32, 3), generator=g),
                torch.randint(0, 10, (2,), generator=g)]
    if preset == "bert-tiny":
        tokens = torch.randint(0, 256, (2, 16), generator=g)
        positions = (torch.rand((2, 16), generator=g) < 0.25).float()
        mask = torch.ones((2, 16), dtype=torch.long)
        mask[1, 10:] = 0
        return [tokens, torch.randint(0, 256, (2, 16), generator=g),
                positions, mask]
    return [torch.randint(0, 256, (2, 24), generator=g),
            torch.randint(0, 256, (2, 12), generator=g),
            torch.randint(0, 256, (2, 12), generator=g)]


def _loss(module, model, batch):
    if module is diffusion:
        images, t, eps = batch
        return diffusion.loss_fn(model, images, t=t, eps=eps)[0]
    if module is bert:
        return bert.mlm_loss(model, *batch)
    return module.loss_fn(model, *batch)[0]


@pytest.mark.parametrize("module,preset", [
    (diffusion, "unet-tiny"), (vit, "vit-tiny"), (bert, "bert-tiny"),
    (t5, "t5-tiny")], ids=["unet-tiny", "vit-tiny", "bert-tiny", "t5-tiny"])
def test_loss_and_gradients_on_the_card_match_the_cpu(module, preset, cuda):
    cpu, card = _pair(module, preset, cuda)
    batch = _batch(preset)
    ref = _loss(module, cpu, batch)
    got = _loss(module, card, _to(batch, cuda))
    assert got.device.type == "cuda"
    np.testing.assert_allclose(float(got.detach()), float(ref.detach()),
                               rtol=1e-5)
    ref_g = torch.autograd.grad(ref, list(cpu.parameters()),
                                allow_unused=True)
    got_g = torch.autograd.grad(got, list(card.parameters()),
                                allow_unused=True)
    floor = GRAD_FLOOR * max(float(a.norm()) for a in ref_g if a is not None)
    for (name, _), a, b in zip(cpu.named_parameters(), ref_g, got_g):
        if a is None:
            assert b is None, name
            continue
        err = float((b.cpu() - a).norm()) / max(float(a.norm()), floor)
        assert err <= TOL, (name, err)


def test_unet_forward_and_ddim_sample_on_the_card_match_the_cpu(cuda):
    cpu, card = _pair(diffusion, "unet-tiny", cuda)
    x, t, _ = _batch("unet-tiny", seed=1)
    with torch.no_grad():
        ref, got = cpu(x, t), card(x.to(cuda), t.to(cuda))
    torch.testing.assert_close(got.cpu(), ref, atol=TOL, rtol=TOL)
    x_T = torch.randn((2, 16, 16, 3), generator=torch.Generator()
                      .manual_seed(2))
    ref = diffusion.ddim_sample(cpu, None, 2, 10, x_T=x_T)
    got = diffusion.ddim_sample(card, None, 2, 10, x_T=x_T.to(cuda))
    assert got.device.type == "cuda"
    # The images reach |3|: fp32 sums over 10 steps (the CPU parity test's
    # sampler bound, 1e-5, times the steps' growth of |x|).
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("preset", ["ddpm-cifar", "sd-base"])
def test_full_width_unet_runs_one_bf16_step_on_the_card(preset, cuda):
    cfg = diffusion.config(preset)
    model = diffusion.init(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    x = torch.randn((2, cfg.image_size, cfg.image_size, cfg.in_channels),
                    device=cuda)
    with torch.no_grad():
        out = model(x, torch.tensor([999, 0], device=cuda))
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert bool(torch.isfinite(out).all())

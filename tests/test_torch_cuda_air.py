"""Data and the predictor on the card.

Needs a CUDA card (marker ``cuda``) and skips where there is none. The
file imports neither JAX nor ``ray_tpu``, so it runs on a host that has
only PyTorch, with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda_air.py

``iter_torch_batches`` with ``device=None`` hands out tensors on the card
holding the rows' values in the JAX package's dtypes, and a
``TorchPredictor`` on the card gives the logits of gpt-micro's forward on
the card, bit for bit, and the CPU's within the fp32 bound of
tests/test_torch_gpt.py.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data
from ray_tpu_torch.models import gpt
from ray_tpu_torch.train import TorchPredictor

pytestmark = pytest.mark.cuda

LOGIT_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def port_cluster():
    ray_tpu_torch.shutdown()
    ctx = ray_tpu_torch.init(num_cpus=4, _memory=1e9)
    yield ctx
    ray_tpu_torch.shutdown()


def test_iter_torch_batches_on_the_card(cuda, port_cluster):
    tokens = np.random.default_rng(0).integers(0, 512, (8, 16))
    ds = data.from_numpy(tokens, column="tokens")
    batches = list(ds.iter_torch_batches(batch_size=4))
    assert len(batches) == 2
    for i, b in enumerate(batches):
        t = b["tokens"]
        assert t.is_cuda and t.dtype == torch.int32  # int64 → int32
        np.testing.assert_array_equal(t.cpu().numpy(),
                                      tokens[4 * i:4 * i + 4])


def test_torch_predictor_on_the_card(cuda):
    cfg = gpt.config("gpt-micro", attn_impl="flash")
    model = gpt.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 256),
                                               dtype=np.int32)
    with torch.no_grad():
        cpu = model(torch.from_numpy(tokens)).numpy()
    pred = TorchPredictor(model, lambda m, b: m(b["tokens"]))
    assert pred.device.type == "cuda"
    out = pred.predict({"tokens": tokens})
    with torch.no_grad():
        card = model(torch.from_numpy(tokens).to(cuda)).cpu().numpy()
    assert out.dtype == np.float32 and out.shape == cpu.shape
    np.testing.assert_array_equal(out, card)
    np.testing.assert_allclose(out, cpu, atol=LOGIT_TOL, rtol=LOGIT_TOL)

"""``@serve.batch`` in the port (``ray_tpu_torch/serve/batching.py``).

The seven ``@serve.batch`` cases of ``tests/test_serve_autoscale.py``
against the port's copy, and the diffusion UNet's serving path on the CPU:
concurrent callers of a ``unet-tiny`` DDIM sampler behind ``serve.batch``
each get their own image, equal to an unbatched call with the same x_T.
"""

import asyncio

import pytest
import torch

from ray_tpu_torch import serve
from ray_tpu_torch.models import diffusion
from ray_tpu_torch.serve.batching import _ADJUST_EVERY, _BatchQueue


def test_batch_rejects_sync_function():
    with pytest.raises(TypeError, match="async"):
        @serve.batch
        def handler(items):
            return items


def test_batch_free_function_accepts_keyword():
    @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.01)
    async def double(items):
        return [i * 2 for i in items]

    async def drive():
        a = await double(3)
        b = await double(items=4)
        return a, b

    assert asyncio.new_event_loop().run_until_complete(drive()) == (6, 8)


def test_batch_method_accepts_keyword():
    class Host:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.01)
        async def call(self, items):
            return [i + 1 for i in items]

    h = Host()

    async def drive():
        return await h.call(1), await h.call(items=2)

    assert asyncio.new_event_loop().run_until_complete(drive()) == (2, 3)


def test_batch_wrong_arity_raises():
    @serve.batch
    async def one(items):
        return items

    async def drive():
        with pytest.raises(TypeError, match="exactly one"):
            await one(1, 2, 3)

    asyncio.new_event_loop().run_until_complete(drive())


def test_adaptive_batching_shrinks_under_latency_pressure():
    @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05,
                 target_latency_s=0.01)
    async def slow(items):
        await asyncio.sleep(0.03)  # always over the 10ms budget
        return items

    async def drive():
        for _ in range(_ADJUST_EVERY + 1):
            await slow(1)
        return slow.batch_stats()

    stats = asyncio.new_event_loop().run_until_complete(drive())
    assert stats["adaptive"]
    assert stats["shrinks"] >= 1
    assert stats["cur_max_batch_size"] < 8
    assert stats["cur_wait_timeout_s"] < 0.05


def test_fixed_batching_never_adapts():
    @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.001)
    async def slow(items):
        await asyncio.sleep(0.01)
        return items

    async def drive():
        for _ in range(_ADJUST_EVERY + 1):
            await slow(1)
        return slow.batch_stats()

    stats = asyncio.new_event_loop().run_until_complete(drive())
    assert not stats["adaptive"]
    assert stats["cur_max_batch_size"] == 8
    assert stats["shrinks"] == 0


def test_adaptive_batching_grows_back_toward_ceiling():
    async def fast(items):
        return items

    async def drive():
        q = _BatchQueue(fast, max_batch_size=8, timeout_s=0.01,
                        target_latency_s=1.0, name="fast")
        q.cur_max = 1  # as if a burst shrank it earlier
        for _ in range(64):
            await q.submit(1)
        return q.stats()

    stats = asyncio.new_event_loop().run_until_complete(drive())
    assert stats["grows"] >= 1
    assert stats["cur_max_batch_size"] > 1


class _Sampler:
    """What ``examples/serve_diffusion.py`` deploys, without the runtime:
    each request is one x_T, and a coalesced batch is one DDIM call."""

    def __init__(self, model, n_steps):
        self.model, self.n_steps = model, n_steps

    @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
    async def __call__(self, x_T_list):
        x_T = torch.stack(x_T_list)
        images = diffusion.ddim_sample(self.model, None, len(x_T_list),
                                       self.n_steps, x_T=x_T)
        return list(images)


def test_concurrent_ddim_requests_coalesce_and_each_get_their_own_image():
    cfg = diffusion.config("unet-tiny")
    model = diffusion.init(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    x_Ts = [torch.randn((cfg.image_size, cfg.image_size, cfg.in_channels),
                        generator=g) for _ in range(4)]
    sampler = _Sampler(model, n_steps=3)

    async def drive():
        return await asyncio.gather(*(sampler(x) for x in x_Ts))

    images = asyncio.new_event_loop().run_until_complete(drive())
    stats = _Sampler.__call__.batch_stats(sampler)
    assert stats["batches"] == 1 and stats["last_batch_size"] == 4
    for x_T, image in zip(x_Ts, images):
        alone = diffusion.ddim_sample(model, None, 1, 3, x_T=x_T[None])[0]
        assert image.shape == alone.shape == x_T.shape
        # The same image as an unbatched call, to fp32 summation order
        # over a batch of 4 against 1 (the images reach |3|).
        torch.testing.assert_close(image, alone, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(images[0], images[1])

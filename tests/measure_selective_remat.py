"""Full against selective remat on the card, for one tree's port.

A one-off measurement, not a test. Each preset named (default gpt-410m)
takes, with its recipe (``RECIPES``: gpt-410m's is the JAX package's own,
``bench.py:2473-2478``, batch 18 x 1024, ``loss_chunk=6144``, chip_smoke.py's
phase 5j; gpt-1.3b's is phase 5's, 12 x 1024, ``loss_chunk=4096``; flash
attention and ``default_optimizer(1e-4)`` in both), under each remat policy
in turn, ``WARMUP`` untimed and ``STEPS`` timed train steps without a mesh
(host clock, synchronised per step), then one step under
``torch.profiler``: its device time, kernel count and host time with the
profiler on. The ``ray_tpu_torch`` imported is the one under ROOT (its
kernels build under ROOT/build/), so that two trees are measured alike, in
turns, on one card:

    git archive <parent> ray_tpu_torch | tar -x -C build/parent
    python3 tests/measure_selective_remat.py build/parent gpt-410m gpt-1.3b
    python3 tests/measure_selective_remat.py . gpt-410m gpt-1.3b

Each run prints the card's name and power limit and one JSON line per
preset and policy. Run from the repo root, on the card.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else \
    pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ray_tpu_torch.models import gpt  # noqa: E402
from ray_tpu_torch.parallel import train_step as ts  # noqa: E402

RECIPES = {"gpt-410m": (18, 1024, 6144), "gpt-1.3b": (12, 1024, 4096)}
PRESETS = sys.argv[2:] or ["gpt-410m"]
WARMUP, STEPS = 2, 6


def _step_profile(step, state, batch):
    """(device ms, kernels, host ms) of one step under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device = sum(e.self_device_time_total for e in events) / 1e3
    return state, device, sum(e.count for e in events), wall * 1e3


def main():
    if not torch.cuda.is_available():
        sys.exit("measure_selective_remat.py: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; ray_tpu_torch from {ROOT}", flush=True)
    for preset in PRESETS:
        _measure(preset)


def _measure(preset):
    batch_size, seq, loss_chunk = RECIPES[preset]
    toks = np.random.default_rng(0).integers(
        0, gpt.config(preset).vocab_size, (batch_size, seq + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).cuda(),
             "targets": torch.from_numpy(toks[:, 1:]).cuda()}
    for policy in ("full", "selective"):
        cfg = gpt.config(preset, attn_impl="flash", remat=True,
                         remat_policy=policy, loss_chunk=loss_chunk)
        opt = ts.default_optimizer(learning_rate=1e-4)
        state = ts.init_train_state(cfg, optimizer=opt, seed=0)
        step = ts.make_train_step(cfg, optimizer=opt)
        times, losses = [], []
        for i in range(WARMUP + STEPS):
            if i == WARMUP:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
        peak = torch.cuda.max_memory_allocated() / 2**30
        state, device, kernels, host = _step_profile(step, state, batch)
        timed = times[WARMUP:]
        print(json.dumps({
            "root": str(ROOT), "preset": preset, "policy": policy,
            "ms": timed,
            "mean_ms": statistics.mean(timed),
            "median_ms": statistics.median(timed),
            "profiled_device_ms": device, "profiled_kernels": kernels,
            "profiled_host_ms": host, "peak_gib": peak,
            "losses": losses}), flush=True)
        del state, step, metrics
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

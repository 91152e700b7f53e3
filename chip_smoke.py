#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero and no result line is
printed:

1. Environment: torch, CUDA, the card, its power limit, nvcc.
2. Build: the port's CUDA kernels from this checkout's sources.
3. Kernel check: K1 (flash attention forward) against its plain PyTorch
   version on the card, at the serving shape and at an fp32 GQA shape;
   times of the kernel, the plain version and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick only, never called by
   the port) beside the least time the card could take.
4. Serving: gpt-1.3b at full width (random weights from a seeded
   generator, bf16 compute, flash attention) answers 8 requests, arriving
   while it decodes, through the port's ContinuousBatcher; later requests
   must join a running batch, and K1 must run once per layer per step.
   Then the same step under dot attention, and gpt-micro on the card
   against the CPU, check what comes out.
5. One JSON line of kernels; the last line is the result.
"""

from __future__ import annotations

import asyncio
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# operations/s by input type (bf16 on the tensor cores, fp32 on the fp32
# pipes). Bounds are stated against these, beside the card's power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Kernel-check bounds. fp32: the kernel and the plain version sum the same
# fp32 products in different orders (the bound of tests/test_ops.py's
# kernel path). bf16: both round out to bf16, and one bf16 ulp (2^-8
# relative) can separate them; lse stays fp32 from the same bf16 inputs.
TOL = {"float32": {"out": 1e-4, "lse": 1e-4},
       "bfloat16": {"out": 2e-2, "lse": 1e-3}}

# gpt-1.3b logits, flash against dot attention in bf16: both paths round
# activations to bf16 several times per layer over 24 layers, and the dot
# path also rounds its scores and probabilities to bf16. Logits are of
# order 1 (|logit| < 8, where a bf16 ulp is at most 2^-5 = 0.031); on the
# CPU at narrower widths (d_model 512-1024, 24 layers, S=256) the gap was
# 0.037-0.049. 0.25 is 8 ulps at the top of that range: a wrong mask or
# scale moves logits by O(1).
FLASH_VS_DOT_TOL = 0.25

# gpt-micro in fp32, the kernel on the card against the plain version on
# the CPU: the bound of tests/test_torch_gpt.py (summation order only).
MICRO_TOL = 1e-4

DEVICE = "cuda"
SERVE_PRESET = "gpt-1.3b"
NUM_SLOTS, SEQ = 4, 1024
N_REQUESTS, MAX_NEW = 8, 16
ARRIVAL_STEPS = 2
PROMPT_LENS = (32, 512)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60)


# -- 1. environment ---------------------------------------------------------

def phase_environment():
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    try:
        import ray_tpu_torch
    except ImportError as exc:
        fail(f"cannot import ray_tpu_torch from {HERE}: {exc}")
    pkg = pathlib.Path(ray_tpu_torch.__file__).resolve().parent
    check(pkg == HERE / "ray_tpu_torch",
          f"ray_tpu_torch resolves to {pkg}, not this checkout's")
    # The product of a float32 matmul on the card is full fp32 here.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"device 0: {name}; device_count {torch.cuda.device_count()}")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    from ray_tpu_torch.ops import _build
    nvcc = run([_build._nvcc(), "--version"])
    check(nvcc.returncode == 0, f"nvcc failed: {nvcc.stderr.strip()}")
    print(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    return torch, name


# -- 2. build ---------------------------------------------------------------

def phase_build():
    from ray_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    seconds = time.perf_counter() - t0
    _build.load()
    print(f"build: {path.relative_to(HERE)} in {seconds:.2f} s")
    # ptxas's report (-Xptxas -v): registers and spills of each kernel.
    log = path.with_suffix(".log")
    if log.exists():
        kernel, spill = "?", ""
        for line in log.read_text().splitlines():
            if "Compiling entry" in line:
                m = re.search(r"(flash_fwd_[a-z]+_kernel)ILi(\d+)E", line)
                kernel = f"{m.group(1)}<{m.group(2)}>" if m else line
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line:
                regs = line.split("Used")[1].split(",")[0].strip()
                print(f"  ptxas: {kernel}: {regs}; {spill}")
    return seconds


# -- 3. kernel check ----------------------------------------------------------

def _median_ms(torch, fn, repeats):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound_ms(B, S, H, KVH, D, dtype_name, causal):
    """Least time for K1's work: each input read once and each output
    written once, against the products the causal mask leaves."""
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * B * S * H * D + 2 * B * S * KVH * D) * elt + B * H * S * 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * D * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _check_kernel(torch, fa, B, S, H, KVH, D, dtype, causal, blk, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (B, S, h, D), dtype=np.float32)).to("cuda", dtype)
        for h in (H, KVH, KVH))
    before = fa.launches
    out, lse = fa._flash_forward(q, k, v, causal, blk, blk)
    torch.cuda.synchronize()
    check(fa.launches == before + 1, "the flash wrapper did not launch K1")
    ref_out, ref_lse = fa._flash_forward_reference(q, k, v, causal, blk,
                                                   blk)
    dname = str(dtype).split(".")[-1]
    tol = TOL[dname]
    d_out = (out.float() - ref_out.float()).abs()
    d_lse = (lse - ref_lse).abs()
    err_out, err_lse = float(d_out.max()), float(d_lse.max())
    tag = (f"B={B} S={S} H={H}/{KVH} D={D} {dname} "
           f"{'causal' if causal else 'full'}")
    print(f"kernel check {tag}: max|dout| {err_out:.3e} "
          f"(bound {tol['out']:.0e}), max|dlse| {err_lse:.3e} "
          f"(bound {tol['lse']:.0e})")
    ok_out = bool((d_out <= tol["out"] + tol["out"] *
                   ref_out.float().abs()).all())
    ok_lse = bool((d_lse <= tol["lse"] + 1e-4 * ref_lse.abs()).all())
    check(ok_out and ok_lse and torch.isfinite(out.float()).all(),
          f"K1 disagrees with its plain version at {tag}")
    return q, k, v, max(err_out, err_lse), dname


def phase_kernel_check(torch):
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa
    # (b) fp32, head dim 80, non-causal, GQA 8 over 2.
    _check_kernel(torch, fa, 2, 256, 8, 2, 80, torch.float32, False, 256, 1)
    # (a) the serving shape: gpt-1.3b's attention in one decode step.
    B, S, H, D = NUM_SLOTS, SEQ, 16, 128
    q, k, v, err, dname = _check_kernel(torch, fa, B, S, H, H, D,
                                        torch.bfloat16, True, 512, 0)
    kernel_ms = _median_ms(
        torch, lambda: fa._flash_forward_cuda(q, k, v, True), 30)
    plain_ms = _median_ms(
        torch, lambda: fa._flash_forward_reference(q, k, v, True, 512, 512),
        10)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa_ms = _median_ms(
        torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True), 30)
    bound_ms, bound_by = _bound_ms(B, S, H, H, D, dname, True)
    print(f"K1 at B={B} S={S} H={H} D={D} bf16 causal: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"kernel at {bound_ms / kernel_ms:.2%} of the bound")
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sdpa_ms}


# -- 4. serving ---------------------------------------------------------------

def _decode_engine(torch, model, serve):
    """Greedy decode over a fixed [NUM_SLOTS, SEQ] token buffer: prefill
    writes a prompt into its slot; a step runs the model over the whole
    buffer and appends the argmax at each active slot's last position
    (causal attention: positions past a slot's length do not change the
    logits before it)."""
    state = {"buf": torch.zeros((NUM_SLOTS, SEQ), dtype=torch.long,
                                device=DEVICE),
             "lens": [0] * NUM_SLOTS}
    rows = torch.arange(NUM_SLOTS, device=DEVICE)

    def prefill(state, slot, prompt):
        state["buf"][slot] = 0
        state["buf"][slot, :len(prompt)] = torch.as_tensor(prompt)
        state["lens"][slot] = len(prompt)
        return state

    def step(state, active_mask):
        with torch.inference_mode():
            logits = model(state["buf"])
            last = logits[rows, torch.tensor(
                [max(n - 1, 0) for n in state["lens"]], device=DEVICE)]
            nxt = last.argmax(-1)
            for slot, live in enumerate(active_mask):
                if live:
                    state["buf"][slot, state["lens"][slot]] = nxt[slot]
                    state["lens"][slot] += 1
        return state, nxt.cpu()

    engine = serve.ContinuousBatcher(state=state, prefill_fn=prefill,
                                     step_fn=step, num_slots=NUM_SLOTS)
    return engine, state


def phase_serving(torch):
    from dataclasses import replace

    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = gpt.config(SERVE_PRESET, attn_impl="flash")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = gpt.init(cfg, gen, device=DEVICE).eval()
    torch.cuda.synchronize()
    print(f"serve: {SERVE_PRESET} ({cfg.num_params() / 1e9:.3f} B params, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}) "
          f"initialised in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    engine, state = _decode_engine(torch, model, serve)
    with torch.inference_mode():  # warm-up: cuBLAS handles, kernel load
        model(state["buf"])
    torch.cuda.synchronize()

    async def drive():
        # Request i arrives once the engine has run ARRIVAL_STEPS * i
        # steps, so later requests join a batch that is already decoding.
        futures = []
        for i, prompt in enumerate(prompts):
            while engine.stats()["iterations"] < ARRIVAL_STEPS * i:
                await asyncio.sleep(0.001)
            futures.append(asyncio.ensure_future(
                engine.submit(prompt, max_new_tokens=MAX_NEW)))
        return await asyncio.gather(*futures)

    fa.launches = 0
    t0 = time.perf_counter()
    outs = asyncio.run(drive())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    stats = engine.stats()
    steps = stats["iterations"]
    check(len(outs) == N_REQUESTS, "not every request was answered")
    check(all(len(o) == MAX_NEW for o in outs),
          f"a request did not return {MAX_NEW} tokens: "
          f"{[len(o) for o in outs]}")
    check(all(type(t) is int and 0 <= t < cfg.vocab_size
              for o in outs for t in o), "a token is outside the vocab")
    check(stats["admitted_running"] >= 1,
          "no request joined a running batch")
    check(launches == cfg.n_layers * steps,
          f"K1 launched {launches} times over {steps} steps, expected "
          f"{cfg.n_layers} per step")
    print(f"serve: {N_REQUESTS} requests, one every {ARRIVAL_STEPS} steps, "
          f"prompt lengths {lens.tolist()}, {MAX_NEW} new tokens each; "
          f"{steps} steps in {wall:.3f} s "
          f"({wall / steps * 1e3:.2f} ms/step, "
          f"{N_REQUESTS * MAX_NEW / wall:.2f} tokens/s); K1 launches "
          f"{launches} = {cfg.n_layers} x {steps}; stats {stats}")
    print(f"serve: first request's tokens {outs[0]}")

    # The last step's buffer under flash and under dot attention.
    with torch.inference_mode():
        flash = model(state["buf"]).float()
        model.cfg = replace(cfg, attn_impl="dot")
        dot = model(state["buf"]).float()
        model.cfg = cfg
    check(flash.shape == (NUM_SLOTS, SEQ, cfg.vocab_size),
          f"logits shape {tuple(flash.shape)}")
    check(bool(torch.isfinite(flash).all()), "non-finite logits")
    gap = float((flash - dot).abs().max())
    print(f"serve: max|logit| {float(flash.abs().max()):.4f}; flash vs dot "
          f"max|dlogit| {gap:.4f} (bound {FLASH_VS_DOT_TOL})")
    check(gap <= FLASH_VS_DOT_TOL, "flash and dot logits disagree")
    del flash, dot
    _profile_step(torch, model, state["buf"])
    del model, state, engine
    torch.cuda.empty_cache()
    return launches


def _profile_step(torch, model, buf):
    """Device time of one serving step's forward, by kernel (a profiler
    window after the counted run; the launches here are not counted)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model(buf)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(buf)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in events)
    if not total:
        print("profile: the profiler saw no device time (not measured)")
        return
    print(f"profile: one forward of [{NUM_SLOTS}, {SEQ}], device time "
          f"{total / 1e3:.3f} ms over {sum(e.count for e in events)} "
          f"kernels; top by device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.self_device_time_total / total:6.1%} x{e.count:<4d} "
              f"{e.key[:160]}")


def phase_small_reference(torch):
    """gpt-micro in fp32 through the kernel on the card against the plain
    version on the CPU, from the same weights and tokens."""
    from ray_tpu_torch.models import gpt
    cfg = gpt.config("gpt-micro", attn_impl="flash")
    cpu = gpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = gpt.GPT(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 256)))
    with torch.inference_mode():
        ref = cpu(tokens)
        got = card(tokens.cuda()).cpu()
    err = float((got - ref).abs().max())
    print(f"gpt-micro fp32, card kernel vs CPU plain version: "
          f"max|dlogit| {err:.3e} (bound {MICRO_TOL:.0e})")
    check(bool(((got - ref).abs() <= MICRO_TOL + MICRO_TOL * ref.abs())
               .all()), "gpt-micro on the card disagrees with the CPU")


def main():
    torch, name = phase_environment()
    phase_build()
    k1 = phase_kernel_check(torch)
    launches = phase_serving(torch)
    phase_small_reference(torch)
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:37",
        "launches": launches, **k1}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

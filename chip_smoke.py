#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero and no result line is
printed:

1. Environment: torch, CUDA, the card, its power limit, nvcc.
2. Build: the port's CUDA kernels from this checkout's sources; ptxas's
   registers and spills of every kernel, and the count of wgmma
   (``HGMMA``) and TMA load (``UTMALDG``) instructions in the SASS of the
   bf16 kernels of K1, K2 and K3, which must use both, and which ptxas
   must neither spill nor serialize.
3. Kernel check: K1 (flash attention forward) against its plain PyTorch
   version on the card, at an fp32 GQA shape, gpt-1.3b's serving and
   training shapes and llama3-8b's (32 query heads over 8 KV heads); then
   K2 and K3 (the backward: dq, and dk/dv) against theirs, at an fp32 GQA
   shape and at both models' training shapes. Times of each kernel (per
   call through its wrapper, and per launch in a stream of launches,
   which hides the host's share), its plain version and PyTorch's
   ``scaled_dot_product_attention`` forward or backward (a yardstick only,
   never called by the port; ``enable_gqa`` under GQA) beside the least
   time the card could take, and the rates the kernel reached.
4. Serving: gpt-1.3b at full width (random weights from a seeded
   generator, bf16 compute, flash attention) answers 8 requests, arriving
   while it decodes, through the port's ContinuousBatcher; later requests
   must join a running batch, and K1 must run once per layer per step.
   Then the same step under dot attention, and gpt-micro on the card
   against the CPU, check what comes out. 4b: llama3-8b at full width and
   depth is served the same way, K1 on grouped-query attention. 4c: the
   same llama3-8b (same seed), placed on a 1-rank mesh by
   ``tp_fsdp_rules()`` (a 1-rank NCCL process group from
   ``prepare_mesh``; FSDP2 and DTensor parameters), runs forward on 4b's
   last buffer: K1 once per layer on the local heads, logits within one
   bf16 ulp at |logit| 8 of 4b's.
5. Training: gpt-1.3b at full width and depth takes 8 steps of the JAX
   package's headline recipe (batch 12 x 1024, flash attention, full
   remat, chunked loss, Adafactor) through the port's train step: 2
   warm-up steps, 6 timed. The step-0 loss must be that of random logits,
   the first update must leave every parameter as it was, and each step
   must launch K1 48 times (forward and remat) and K2 and K3 24 times.
   Then steps under selective remat, which must launch K1 only 24 times
   (its out and lse are kept), a profile of one step, which must show
   the three wgmma kernels by name, and gpt-micro's
   first gradients and train step on the card against the CPU (3 steps,
   accumulation 1 and 2). 5b: llama3-8b at full width and depth takes 6
   steps (2 warm-up) of batch 1 x 4096 (flash attention, remat, the
   unchunked loss, Adafactor), each launching K1 64 times and K2 and K3
   32 times, with the same checks of the step-0 loss and first update,
   its peak memory and a profile of one step. 5c: llama-micro (fp32, 8
   query heads over 4 KV heads) on the card against the CPU: logits,
   first gradients and 3 Adafactor steps. 5d: phase 5's recipe through the
   1-rank mesh, under the JAX package's single-chip rules (all None,
   bench.py) and under ``tp_fsdp_rules()``: 2 warm-up and 4 timed steps
   each, (48, 24, 24) launches a step, each step's loss and the first
   update held to phase 5's, ms per step, MFU and peak memory beside
   phase 5's, and a profile of one step.
6. One JSON line of kernels (ms and library_ms per call, launch_ms and
   library_launch_ms per launch, at gpt-1.3b's shapes; the same at
   llama3-8b's under "llama3_8b"); the last line is the result.

``python3 chip_smoke.py --kernel-times ROOT`` runs phase 3 alone for the
``ray_tpu_torch`` of the checkout at ROOT (its kernels build under
ROOT/build/), so that two trees' kernels are timed by one method in one
call; it prints no result line.
"""

from __future__ import annotations

import asyncio
import gc
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

# K2/K3 against the plain backward (tests/test_torch_cuda_kernels.py's
# bounds, atol and rtol). fp32: tests/test_ops.py's backward bound. bf16:
# both round the gradients out to bf16 and the kernels also round p and ds
# to bf16 where they multiply, as K1 rounds p: K1's 2e-2.
BWD_TOL = {"float32": 2e-3, "bfloat16": 2e-2}

# gpt-micro in fp32, 3 train steps on the card (K1-K3) against the CPU
# (plain versions) from the same weights and batches: the loss to
# summation order (1e-5 relative, tests/test_torch_train_step.py). The
# parameters by the size of what the steps changed: AdamW divides each
# element's step by its gradient's RMS, so an element whose gradient is
# within a few eps (1e-8) of 0 moves by a different fraction of the
# learning rate when the gradient's summation order changes (on the CPU,
# dot against flash attention moves single wte entries by 2.1e-5 of a
# 2.0e-3 step, 7e-5 of the step's norm). Each tensor's difference is held
# to 1e-3 of the norm of its change; a wrong gradient changes it by O(1).
MICRO_LOSS_RTOL = 1e-5
MICRO_UPDATE_RTOL = 1e-3
# The first step's gradients, card (K1-K3) against CPU, before AdamW
# (whose update would hide a wrong gradient's scale): each tensor's
# difference over its norm. fp32 sums in different orders: the 1e-4 of
# MICRO_TOL; a gradient scaled or summed wrongly differs by O(1).
MICRO_GRAD_RTOL = 1e-4

DEVICE = "cuda"
SERVE_PRESET = "gpt-1.3b"
# The JAX package's headline training recipe (bench.py, bench_gptj6b).
TRAIN_PRESET = "gpt-1.3b"
TRAIN_BATCH, TRAIN_SEQ = 12, 1024
TRAIN_WARMUP, TRAIN_STEPS = 2, 6
SELECTIVE_STEPS = 3
TRAIN_OVERRIDES = dict(attn_impl="flash", remat=True, remat_policy="full",
                       loss_chunk=4096)
# Step-0 loss of random logits: after the final LayerNorm each hidden unit
# has variance 1, so a logit of the N(0, 0.02^2) head has std
# 0.02 * sqrt(2048) = 0.905, and the cross-entropy of a random target is
# ln(50304) + 0.905^2 / 2 = 11.24.
LOSS0, LOSS0_TOL = 11.24, 0.3
# llama3-8b (ray_tpu/models/llama.py: 32 layers, d_model 4096, 32 query
# heads over 8 KV heads of 128, d_ff 14336, vocab 128256, rope_theta
# 500000), served as gpt-1.3b is and trained at batch 1 x 4096 with flash
# attention and remat (the preset's own), under Adafactor.
LLAMA_PRESET = "llama3-8b"
LLAMA_HEADS = (32, 8)
LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ = 1, 4096
LLAMA_WARMUP, LLAMA_STEPS = 2, 4
# Step-0 loss of random logits, as LOSS0: after the final RMSNorm each
# hidden unit has mean square 1, so a logit of the N(0, 0.02^2) head has
# std 0.02 * sqrt(4096) = 1.28 and the cross-entropy of a random target is
# ln(128256) + 1.28^2 / 2 = 12.58 (on the CPU at d_model 4096, 2 layers,
# vocab 8192: 9.814 against the formula's 9.830).
LLAMA_LOSS0, LLAMA_LOSS0_TOL = 12.58, 0.3
# llama3-8b logits, flash against dot attention in bf16. Both paths round
# to bf16 several times per layer, and at d_model 4096 the logits' std is
# 0.02 * sqrt(4096) = 1.28, so |logit| reaches 8, where a bf16 ulp is
# 2^-4 = 0.0625. On the CPU at d_model 4096 (2-8 layers, S=1024) the gap
# was 0.15-0.19, and each path was 0.14-0.21 from the same forward in fp32;
# on the card at 32 layers and [4, 1024] it was 0.59 (9.5 ulps). 1.0 is 16
# ulps at the top of the range. _serve also runs the step in fp32 and holds
# flash to it by the same bound, so a wrong mask, scale or KV head, which
# moves flash's logits by O(1) while dot stays put, does not pass.
LLAMA_FLASH_VS_DOT_TOL = 1.0
# Phases 4c and 5d: the JAX package's single-chip path on a 1-rank mesh.
MESH_WARMUP, MESH_STEPS = 2, 4
# 4c: llama3-8b's logits on the mesh against 4b's (bf16 |logit| up to 8,
# where a bf16 ulp is 2^-4): one rank runs the same ops in the same order,
# so they are expected bit-equal; one ulp at the top of the range is the
# most a changed rounding of the same forward could move them, and a wrong
# head block or vocab offset moves them by O(1).
MESH_LOGITS_TOL = 0.0625
# 5d: each step's loss on the mesh against phase 5's same step (same
# weights, batch and seed). One rank runs the same ops, plus collectives
# over one rank that copy exactly, so they are expected bit-equal; the
# bound is fp32 summation order (tests/test_torch_train_step.py's
# STEP_RTOL), where a wrong mask count, vocab offset or gradient scale
# moves the loss by 1e-3 or more within the steps.
MESH_LOSS_RTOL = 1e-5
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


# The bf16 kernels built on wgmma fed by TMA (K1, K2 and K3): their SASS
# must hold both kinds of instruction, and ptxas must not spill them nor
# serialize their wgmma. tests/test_torch_build.py checks that every
# *_wgmma_kernel under ray_tpu_torch/ops/csrc/ is named here.
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel")
KERNEL_NAME = re.compile(r"(flash_[a-z_]+_kernel)ILi(\d+)E")


# -- 1. environment ---------------------------------------------------------

def phase_environment(root=HERE):
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    sys.path.insert(0, str(root))
    try:
        import ray_tpu_torch
    except ImportError as exc:
        fail(f"cannot import ray_tpu_torch from {root}: {exc}")
    pkg = pathlib.Path(ray_tpu_torch.__file__).resolve().parent
    check(pkg == root / "ray_tpu_torch",
          f"ray_tpu_torch resolves to {pkg}, not {root}'s")
    # The product of a float32 matmul on the card is full fp32 here.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    import inspect

    from torch.distributed.fsdp import fully_shard
    check("shard_placement_fn" in inspect.signature(fully_shard).parameters,
          f"torch {torch.__version__}: fully_shard takes no "
          f"shard_placement_fn")
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
    # ptxas's report (-Xptxas -v): registers and spills of each kernel,
    # and any product it had to serialize (C7514, C7520). Neither may touch a
    # wgmma kernel.
    log = path.with_suffix(".log")
    check(log.exists(), f"no ptxas report beside {path.name}")
    kernel, spill, faults = "?", "", []
    for line in log.read_text().splitlines():
        if "Compiling entry" in line:
            m = KERNEL_NAME.search(line)
            kernel = f"{m.group(1)}<{m.group(2)}>" if m else line
        elif "spill" in line:
            spill = line.strip()
            if (kernel.split("<")[0] in WGMMA_KERNELS
                    and re.search(r"\b[1-9]\d* bytes spill", line)):
                faults.append(f"{kernel}: {spill}")
        elif "Used" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            print(f"  ptxas: {kernel}: {regs}; {spill}")
        elif "Performance Loss" in line:
            print(f"  ptxas: {line.strip()}")
            m = KERNEL_NAME.search(line)
            if (m.group(1) if m else kernel.split("<")[0]) in WGMMA_KERNELS:
                faults.append(line.strip())
    check(not faults, f"ptxas spilled or serialized a wgmma kernel: {faults}")
    _sass_counts(_build, path)
    return seconds


def _sass_counts(_build, path):
    """wgmma (HGMMA), TMA load (UTMALDG) and TMA store (UTMASTG)
    instructions in the SASS of each instance of the wgmma kernels."""
    nvcc = pathlib.Path(_build._nvcc())
    tool = nvcc.parent / "cuobjdump"
    if not tool.exists():
        print(f"  sass: cuobjdump not found beside {nvcc}: HGMMA and "
              f"UTMALDG not counted")
        return
    sass = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                          text=True, timeout=120)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()}")
    counts, kernel = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            m = KERNEL_NAME.search(line)
            kernel = (m.group(1), int(m.group(2))) if m else None
            if kernel and kernel[0] in WGMMA_KERNELS:
                counts[kernel] = dict.fromkeys(("HGMMA", "UTMALDG",
                                                "UTMASTG"), 0)
        elif kernel in counts:
            for op in counts[kernel]:
                counts[kernel][op] += f" {op}." in line or f" {op} " in line
    for name in WGMMA_KERNELS:
        dims = sorted(d for n, d in counts if n == name)
        check(dims, f"no {name} in the library's SASS")
        for d in dims:
            c = counts[(name, d)]
            print(f"  sass: {name}<{d}>: HGMMA {c['HGMMA']}, UTMALDG "
                  f"{c['UTMALDG']}, UTMASTG {c['UTMASTG']}")
            check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
                  f"{name}<{d}> has no wgmma or no TMA load in its SASS")


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


def _median_ms_per_launch(torch, fn, repeats, launches=10):
    """Median device time per launch over samples of ``launches``
    launches back to back between two events: the host enqueues ahead of
    the card, so its time per call is hidden."""
    return _median_ms(torch, lambda: [fn() for _ in range(launches)],
                      repeats) / launches


def _work(B, S, H, KVH, D, dtype_name, causal, kernel="fwd"):
    """Bytes and flops of a flash kernel's work: each input read once and
    each output written once, and the products the causal mask leaves.
    K1 reads q, k, v and writes out and lse: 2 products (4 D flops) per
    pair. K2 reads q, k, v, dO, lse and delta and writes dq: 3 products
    (6 D). K3 reads the same and writes dk and dv: 4 products (8 D)."""
    elt = 2 if dtype_name == "bfloat16" else 4
    q_elems, kv_elems, rows = B * S * H * D, B * S * KVH * D, B * H * S
    elems, fp32_rows, flops_per_pair = {
        "fwd": (2 * q_elems + 2 * kv_elems, rows, 4),
        "dq": (3 * q_elems + 2 * kv_elems, 2 * rows, 6),
        "dkv": (2 * q_elems + 4 * kv_elems, 2 * rows, 8)}[kernel]
    nbytes = elems * elt + fp32_rows * 4
    pairs = S * (S + 1) // 2 if causal else S * S
    return nbytes, flops_per_pair * B * H * D * pairs


def _bound_ms(B, S, H, KVH, D, dtype_name, causal, kernel="fwd"):
    """Least time for a flash kernel's work (:func:`_work`) at the card's
    peak memory rate and peak rate for the input type, and which binds."""
    nbytes, flops = _work(B, S, H, KVH, D, dtype_name, causal, kernel)
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


def _rates(B, S, H, KVH, D, dname, kernel, ms):
    """The kernel's achieved TFLOP/s and GB/s at ``ms`` (its work from
    :func:`_work`, not what it re-reads or recomputes)."""
    nbytes, flops = _work(B, S, H, KVH, D, dname, True, kernel)
    return f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s"


def _k1_times(torch, fa, q, k, v, dname):
    """K1's time at q, k, v (bf16, causal) beside its plain version's,
    SDPA's and the bound; printed and returned as a kernels-line row: ms
    and library_ms per call (each synchronised on its own, host time
    included), launch_ms and library_launch_ms per launch in a stream of
    launches."""
    import torch.nn.functional as F
    B, S, H, D = q.shape
    kvh = k.shape[2]
    call_ms = _median_ms(
        torch, lambda: fa._flash_forward_cuda(q, k, v, True), 30)
    kernel_ms = _median_ms_per_launch(
        torch, lambda: fa._flash_forward_cuda(q, k, v, True), 30)
    plain_ms = _median_ms(
        torch, lambda: fa._flash_forward_reference(q, k, v, True, 512, 512),
        10)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=kvh != H)
    sdpa_call_ms = _median_ms(torch, sdpa, 30)
    sdpa_ms = _median_ms_per_launch(torch, sdpa, 30)
    bound_ms, bound_by = _bound_ms(B, S, H, kvh, D, dname, True)
    print(f"K1 at B={B} S={S} H={H}/{kvh} D={D} bf16 causal: kernel "
          f"{call_ms:.4f} ms per call ({kernel_ms:.4f} per launch), plain "
          f"{plain_ms:.4f} ms, sdpa {sdpa_call_ms:.4f} ms per call "
          f"({sdpa_ms:.4f} per launch), bound {bound_ms:.4f} ms "
          f"({bound_by}); kernel at {bound_ms / call_ms:.2%} of the bound "
          f"per call ({bound_ms / kernel_ms:.2%} per launch), per launch "
          f"{_rates(B, S, H, kvh, D, dname, 'fwd', kernel_ms)}")
    return {"ms": call_ms, "launch_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sdpa_call_ms, "library_launch_ms": sdpa_ms}


def phase_kernel_check(torch):
    """K1 at an fp32 GQA shape, and at the serving and training shapes of
    gpt-1.3b and llama3-8b; the kernels line reports the serving shapes."""
    from ray_tpu_torch.ops import flash_attention as fa
    # (b) fp32, head dim 80, non-causal, GQA 8 over 2.
    _check_kernel(torch, fa, 2, 256, 8, 2, 80, torch.float32, False, 256, 1)
    # (a) the serving shape: gpt-1.3b's attention in one decode step.
    q, k, v, err, dname = _check_kernel(torch, fa, NUM_SLOTS, SEQ, 16, 16,
                                        128, torch.bfloat16, True, 512, 0)
    row = {"max_abs_err": err, **_k1_times(torch, fa, q, k, v, dname)}
    # (c) the training shape: gpt-1.3b's attention in one training step,
    # where K1 runs once per layer forward and once per layer in remat.
    q, k, v, _, _ = _check_kernel(torch, fa, TRAIN_BATCH, TRAIN_SEQ, 16, 16,
                                  128, torch.bfloat16, True, 512, 2)
    _k1_times(torch, fa, q, k, v, dname)
    # (d, e) llama3-8b's serving and training shapes: 32 query heads over 8
    # KV heads, k and v drawn for each head, the model's 1024 x 1024 tiles
    # in the plain version.
    H, KVH = LLAMA_HEADS
    q, k, v, err, _ = _check_kernel(torch, fa, NUM_SLOTS, SEQ, H, KVH, 128,
                                    torch.bfloat16, True, 1024, 5)
    row["llama3_8b"] = {"max_abs_err": err,
                        **_k1_times(torch, fa, q, k, v, dname)}
    q, k, v, _, _ = _check_kernel(torch, fa, LLAMA_TRAIN_BATCH,
                                  LLAMA_TRAIN_SEQ, H, KVH, 128,
                                  torch.bfloat16, True, 1024, 6)
    row["llama3_8b"]["training"] = _k1_times(torch, fa, q, k, v, dname)
    del q, k, v
    torch.cuda.empty_cache()
    return row


def _check_backward(torch, fa, B, S, H, KVH, D, dtype, causal, blk, seed):
    """K2 and K3 through their wrappers against the plain backward on the
    same inputs (out and lse from K1)."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (B, S, h, D), dtype=np.float32)).to("cuda", dtype)
        for h in (H, KVH, KVH, H))
    out, lse = fa._flash_forward_cuda(q, k, v, causal)
    delta = fa._delta(out, g)
    before = (fa.dq_launches, fa.dkv_launches)
    dq = fa._flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal)
    torch.cuda.synchronize()
    check((fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1),
          "the backward wrappers did not launch K2 and K3")
    ref_dq = fa._flash_bwd_dq_reference(q, k, v, g, lse, delta, causal, blk,
                                        blk)
    ref_dk, ref_dv = fa._flash_bwd_dkv_reference(q, k, v, g, lse, delta,
                                                 causal, blk, blk)
    dname = str(dtype).split(".")[-1]
    tol = BWD_TOL[dname]
    tag = (f"B={B} S={S} H={H}/{KVH} D={D} {dname} "
           f"{'causal' if causal else 'full'}")
    errs = {}
    for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                           ("dv", dv, ref_dv)):
        diff = (got.float() - ref.float()).abs()
        errs[name] = float(diff.max())
        check(bool((diff <= tol + tol * ref.float().abs()).all())
              and bool(torch.isfinite(got.float()).all()),
              f"{'K2' if name == 'dq' else 'K3'} disagrees with its plain "
              f"version in {name} at {tag} (max |d| {errs[name]:.3e})")
    print(f"backward check {tag}: max|ddq| {errs['dq']:.3e}, max|ddk| "
          f"{errs['dk']:.3e}, max|ddv| {errs['dv']:.3e} (bound {tol:.0e} "
          f"abs + rel)")
    return (q, k, v, g, out, lse, delta), errs, dname


def _bwd_times(torch, fa, B, S, H, KVH, D, blk, seed):
    """K2 and K3 checked at one bf16 causal shape, with times of each
    kernel, its plain version (tiles of ``blk``) and SDPA's backward;
    printed and returned as kernels-line rows."""
    import torch.nn.functional as F
    (q, k, v, g, out, lse, delta), errs, dname = _check_backward(
        torch, fa, B, S, H, KVH, D, torch.bfloat16, True, blk, seed)
    dq = lambda: fa._flash_bwd_dq_cuda(q, k, v, g, lse, delta, True)
    dkv = lambda: fa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, True)
    call_ms = {"dq": _median_ms(torch, dq, 30), "dkv": _median_ms(torch, dkv,
                                                                   30)}
    dq_ms = _median_ms_per_launch(torch, dq, 30)
    dkv_ms = _median_ms_per_launch(torch, dkv, 30)
    dq_plain = _median_ms(torch, lambda: fa._flash_bwd_dq_reference(
        q, k, v, g, lse, delta, True, blk, blk), 5)
    dkv_plain = _median_ms(torch, lambda: fa._flash_bwd_dkv_reference(
        q, k, v, g, lse, delta, True, blk, blk), 5)
    # The yardstick: SDPA's backward, which computes dq, dk and dv at once.
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    ref_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=KVH != H)
    gt = g.transpose(1, 2).contiguous()
    sdpa_bwd = lambda: torch.autograd.grad(ref_out, (qt, kt, vt), gt,
                                           retain_graph=True)
    sdpa_bwd_call_ms = _median_ms(torch, sdpa_bwd, 30)
    sdpa_bwd_ms = _median_ms_per_launch(torch, sdpa_bwd, 30)
    rows = {}
    for name, kernel, ms, plain, err in (
            ("K2", "dq", dq_ms, dq_plain, errs["dq"]),
            ("K3", "dkv", dkv_ms, dkv_plain, max(errs["dk"], errs["dv"]))):
        bound_ms, bound_by = _bound_ms(B, S, H, KVH, D, dname, True, kernel)
        per_call = call_ms[kernel]
        print(f"{name} at B={B} S={S} H={H}/{KVH} D={D} bf16 causal: kernel "
              f"{per_call:.4f} ms per call ({ms:.4f} per launch), plain "
              f"{plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); kernel "
              f"at {bound_ms / per_call:.2%} of the bound per call "
              f"({bound_ms / ms:.2%} per launch), per launch "
              f"{_rates(B, S, H, KVH, D, dname, kernel, ms)}")
        rows[kernel] = {"max_abs_err": err, "ms": per_call, "launch_ms": ms,
                        "plain_ms": plain, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": sdpa_bwd_call_ms,
                        "library_launch_ms": sdpa_bwd_ms}
    print(f"SDPA backward at H={H}/{KVH} (dq, dk and dv at once) "
          f"{sdpa_bwd_call_ms:.4f} ms per call ({sdpa_bwd_ms:.4f} per "
          f"launch); K2 + K3 {call_ms['dq'] + call_ms['dkv']:.4f} ms per "
          f"call ({dq_ms + dkv_ms:.4f} per launch)")
    del q, k, v, g, out, lse, delta, qt, kt, vt, ref_out, gt
    torch.cuda.empty_cache()
    return rows["dq"], rows["dkv"]


def phase_backward_check(torch):
    """K2/K3 at an fp32 GQA shape and at gpt-1.3b's and llama3-8b's
    training shapes, with times of each kernel, its plain version and
    SDPA's backward; the kernels line reports gpt-1.3b's shape."""
    from ray_tpu_torch.ops import flash_attention as fa
    _check_backward(torch, fa, 2, 256, 8, 2, 80, torch.float32, False, 256,
                    3)
    # The plain version's tiles: GPTConfig's attn_blk_q/k (512), Llama's
    # flash tiles (1024).
    k2, k3 = _bwd_times(torch, fa, TRAIN_BATCH, TRAIN_SEQ, 16, 16, 128, 512,
                        4)
    k2["llama3_8b"], k3["llama3_8b"] = _bwd_times(
        torch, fa, LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ, *LLAMA_HEADS, 128,
        1024, 7)
    return k2, k3


def _zero_counts(fa):
    fa.launches = fa.dq_launches = fa.dkv_launches = 0


def _counts(fa):
    return fa.launches, fa.dq_launches, fa.dkv_launches


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
    from ray_tpu_torch.models import gpt
    return _serve(torch, gpt, gpt.config(SERVE_PRESET, attn_impl="flash"),
                  SERVE_PRESET, FLASH_VS_DOT_TOL)[0]


def phase_llama_serving(torch):
    """llama3-8b served as gpt-1.3b is: K1 on 32 query heads over 8 KV
    heads, once per layer per step."""
    from ray_tpu_torch.models import llama
    return _serve(torch, llama, llama.config(LLAMA_PRESET, attn_impl="flash"),
                  LLAMA_PRESET, LLAMA_FLASH_VS_DOT_TOL)


def _all_rules():
    """bench.py's single-chip rules: nothing sharded, the batch whole."""
    from ray_tpu_torch.parallel import ShardingRules
    return ShardingRules(batch=None, embed=None, heads=None, kv_heads=None,
                         mlp=None, vocab=None)


def _check_placed(model, rules_name):
    """The model went through shard_model: FSDP2 modules whose parameters
    are DTensors on the (dp, fsdp, tp) mesh."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor
    params = dict(model.named_parameters())
    check(isinstance(model, FSDPModule)
          and all(isinstance(b, FSDPModule) for b in model.blocks)
          and all(isinstance(p, DTensor) for p in params.values()),
          f"{rules_name}: the model is not placed by FSDP2 and DTensor")
    wq = params["blocks.0.wq"]
    print(f"mesh: {rules_name}: blocks.0.wq {tuple(wq.shape)} on "
          f"{wq.device_mesh.mesh_dim_names} as {wq.placements}")


def phase_llama_mesh_forward(torch, mesh, buf, want):
    """llama3-8b from 4b's seed, placed on the 1-rank mesh by
    tp_fsdp_rules(), runs forward on 4b's last buffer: K1 once per layer,
    logits against 4b's. Returns the K1 launches."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import tp_fsdp_rules

    cfg = llama.config(LLAMA_PRESET, attn_impl="flash")
    t0 = time.perf_counter()
    model = llama.init(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                       DEVICE, mesh=mesh, rules=tp_fsdp_rules())
    torch.cuda.synchronize()
    print(f"mesh: {LLAMA_PRESET} initialised on the mesh in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    _check_placed(model, "tp_fsdp_rules()")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fa)
    t0 = time.perf_counter()
    with torch.no_grad():
        got = model(buf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, dq_n, dkv_n = _counts(fa)
    check(launches == cfg.n_layers and dq_n == dkv_n == 0,
          f"the mesh forward launched (K1, K2, K3) {(launches, dq_n, dkv_n)}"
          f", expected ({cfg.n_layers}, 0, 0)")
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"logits {tuple(got.shape)} {got.dtype}, 4b's "
          f"{tuple(want.shape)} {want.dtype}")
    gap = float((got.float() - want.float()).abs().max())
    print(f"mesh: {LLAMA_PRESET} forward of {tuple(buf.shape)} on the mesh "
          f"in {wall * 1e3:.2f} ms (first call), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 "
          f"launches {launches}; max|dlogit| against 4b {gap:.6f} (bound "
          f"{MESH_LOGITS_TOL}), bit-equal {torch.equal(got, want)}")
    check(bool(torch.isfinite(got).all()), "non-finite mesh logits")
    check(gap <= MESH_LOGITS_TOL,
          "the mesh forward's logits disagree with 4b's")
    del model, got
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _serve(torch, module, cfg, preset, flash_vs_dot_tol):
    """8 requests through the port's ContinuousBatcher over ``module``'s
    model at ``cfg`` (random weights from a seeded generator, flash
    attention); then the last step's logits under flash and dot attention,
    and a profile of one step. Frees the model and returns the K1 launches
    of the served run, the last step's buffer and its flash logits."""
    from dataclasses import replace

    from ray_tpu_torch import serve
    from ray_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = module.init(cfg, gen, device=DEVICE).eval()
    torch.cuda.synchronize()
    heads = f"{cfg.n_heads}/{cfg.kv_heads}"
    print(f"serve: {preset} ({cfg.num_params() / 1e9:.3f} B params, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads {heads}, "
          f"{cfg.dtype}) initialised in {time.perf_counter() - t0:.2f} s")
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

    _zero_counts(fa)
    t0 = time.perf_counter()
    outs = asyncio.run(drive())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, dq_n, dkv_n = _counts(fa)
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
    check(dq_n == dkv_n == 0, "serving launched a backward kernel")
    print(f"serve: {preset}: {N_REQUESTS} requests, one every "
          f"{ARRIVAL_STEPS} steps, prompt lengths {lens.tolist()}, {MAX_NEW} "
          f"new tokens each; {steps} steps in {wall:.3f} s "
          f"({wall / steps * 1e3:.2f} ms/step, "
          f"{N_REQUESTS * MAX_NEW / wall:.2f} tokens/s); K1 launches "
          f"{launches} = {cfg.n_layers} x {steps}; stats {stats}")
    print(f"serve: first request's tokens {outs[0]}")

    # The last step's buffer under flash and under dot attention, and under
    # dot attention in fp32 (parameters are fp32; TF32 is off).
    with torch.inference_mode():
        flash_raw = model(state["buf"])
        flash = flash_raw.float()
        model.cfg = replace(cfg, attn_impl="dot")
        dot = model(state["buf"]).float()
        model.cfg = replace(cfg, attn_impl="dot", dtype=torch.float32)
        fp32 = model(state["buf"])
        model.cfg = cfg
    check(flash.shape == (NUM_SLOTS, SEQ, cfg.vocab_size),
          f"logits shape {tuple(flash.shape)}")
    check(bool(torch.isfinite(flash).all()), "non-finite logits")
    gap, gap32, dot32 = (float((a - b).abs().max()) for a, b in (
        (flash, dot), (flash, fp32), (dot, fp32)))
    print(f"serve: {preset}: max|logit| {float(flash.abs().max()):.4f}; "
          f"flash vs dot max|dlogit| {gap:.4f} (bound {flash_vs_dot_tol}); "
          f"against the fp32 forward: flash {gap32:.4f} (same bound), dot "
          f"{dot32:.4f}")
    check(gap <= flash_vs_dot_tol, "flash and dot logits disagree")
    check(gap32 <= flash_vs_dot_tol,
          "flash logits disagree with the fp32 forward")
    del flash, dot, fp32
    _profile_step(torch, model, state["buf"])
    buf = state["buf"].clone()
    # The engine's parked decode task and the engine refer to each other:
    # collect the cycle, so the model's memory is free for later phases.
    del model, state, engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches, buf, flash_raw


def _profile_step(torch, model, buf):
    """Device time of one serving step's forward, by kernel (a profiler
    window after the counted run; the launches here are not counted)."""
    def forward():
        with torch.inference_mode():
            model(buf)
    forward()  # warm
    torch.cuda.synchronize()
    _profile(torch, forward, f"one forward of [{NUM_SLOTS}, {SEQ}]", 8)


def _profile(torch, fn, what, top, expect=()):
    """Run fn once under torch.profiler and print its device time by
    kernel, the top ``top`` kernels by device time, the port's flash
    kernels by name, and the step's time on the host clock. Each name in
    ``expect`` must be among the kernels the profiler saw."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in events)
    if not total:
        print("profile: the profiler saw no device time (not measured)")
        return
    print(f"profile: {what}, device time {total / 1e3:.3f} ms over "
          f"{sum(e.count for e in events)} kernels in {wall * 1e3:.3f} ms "
          f"on the host clock (profiler on); top by device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.self_device_time_total / total:6.1%} x{e.count:<4d} "
              f"{e.key[:160]}")
    for e in events:
        if "flash_" in e.key:
            print(f"  flash kernel: {e.self_device_time_total / 1e3:8.3f} "
                  f"ms x{e.count:<4d} {e.key[:160]}")
    missing = [n for n in expect if not any(n in e.key for e in events)]
    check(not missing, f"the profile saw no {missing}")
    classes = {"the port's flash kernels": ("flash_",),
               "GEMMs (cuBLAS)": ("nvjet", "gemm", "cutlass", "xmma")}
    rest = total
    for label, keys in classes.items():
        t = sum(e.self_device_time_total for e in events
                if any(k in e.key for k in keys))
        rest -= t
        print(f"  by class: {label} {t / 1e3:.3f} ms ({t / total:.1%})")
    print(f"  by class: everything else {rest / 1e3:.3f} ms "
          f"({rest / total:.1%})")


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


# -- 5. training --------------------------------------------------------------

def _train_batch(torch, cfg, batch, seq, seed, device):
    """Random tokens as bench.py makes them: targets are the next token."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (batch, seq + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1]).to(device),
            "targets": torch.from_numpy(toks[:, 1:]).to(device)}


def phase_training(torch):
    """gpt-1.3b's headline recipe through the port's train step."""
    from dataclasses import replace

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import train_step as ts

    cfg = gpt.config(TRAIN_PRESET, **TRAIN_OVERRIDES)
    opt = ts.memory_efficient_optimizer(learning_rate=1e-4)
    t0 = time.perf_counter()
    state = ts.init_train_state(cfg, optimizer=opt, seed=0, device=DEVICE)
    step = ts.make_train_step(cfg, optimizer=opt)
    batch = _train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, 0, DEVICE)
    model = state["params"]
    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.synchronize()
    print(f"train: {TRAIN_PRESET} ({cfg.num_params() / 1e9:.3f} B params, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_OVERRIDES}, Adafactor lr "
          f"1e-4; state initialised in {time.perf_counter() - t0:.2f} s")

    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    losses, step_s, per_step, prints = [], [], [], []
    _zero_counts(fa)
    for i in range(n_steps):
        if i == TRAIN_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        counts0 = _counts(fa)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(tuple(b - a for a, b in zip(counts0, _counts(fa))))
        losses.append(float(metrics["loss"]))
        if i == 0:
            same = all(torch.equal(p, b)
                       for p, b in zip(model.parameters(), before))
            check(same, "the first update changed a parameter")
            del before
        if i < MESH_WARMUP + MESH_STEPS:  # phase 5d's reference
            prints.append(_fingerprint(torch, dict(model.named_parameters())))
    counts = _counts(fa)
    peak_full = torch.cuda.max_memory_allocated()

    per_layer = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    check(all(c == per_layer for c in per_step),
          f"launches per step (K1, K2, K3) {per_step}, expected {per_layer}")
    check(np.isfinite(losses).all() and abs(losses[0] - LOSS0) <= LOSS0_TOL,
          f"step-0 loss {losses[0]} is not within {LOSS0_TOL} of {LOSS0}")
    timed = step_s[TRAIN_WARMUP:]
    mean_s = statistics.mean(timed)
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / mean_s
    mfu = tokens_s * gpt.flops_per_token(cfg) / PEAK_FLOPS["bfloat16"]
    print(f"train: losses {[round(x, 5) for x in losses]}; first update "
          f"left every parameter unchanged")
    print(f"train: {TRAIN_STEPS} timed steps: "
          f"{[round(t * 1e3, 2) for t in timed]} ms; mean {mean_s * 1e3:.2f}"
          f" ms/step (std {statistics.pstdev(timed) * 1e3:.2f}), "
          f"{tokens_s:.1f} tokens/s, model FLOPs "
          f"{gpt.flops_per_token(cfg):.4e}/token, MFU {mfu:.2%} of the "
          f"989 TFLOP/s bf16 peak; peak memory "
          f"{peak_full / 2**30:.2f} GiB (full remat)")
    print(f"train: launches over {n_steps} steps (K1, K2, K3) {counts} = "
          f"{per_layer} per step")

    # Memory of the loss and its gradients alone (activations and grads,
    # above the parameters and optimizer state), under each remat policy.
    for policy in ("full", "selective"):
        model.cfg = replace(cfg, remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, _ = gpt.loss_fn(model, batch["tokens"], batch["targets"])
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        print(f"train: {policy} remat: loss and gradients peak at "
              f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} "
              f"GiB above the {base / 2**30:.2f} GiB of state")
        del loss, grads

    # Steps under selective remat: their time, peak memory and launches.
    # Each block keeps the flash forward's out and lse, so K1 runs once
    # per layer (no re-run in the backward).
    model.cfg = replace(cfg, remat_policy="selective")
    sel_step = ts.make_train_step(model.cfg, optimizer=opt)
    state, _ = sel_step(state, batch)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sel_s, sel_counts = [], []
    for _ in range(SELECTIVE_STEPS):
        counts0 = _counts(fa)
        t0 = time.perf_counter()
        state, metrics = sel_step(state, batch)
        torch.cuda.synchronize()
        sel_s.append(time.perf_counter() - t0)
        sel_counts.append(tuple(b - a for a, b in zip(counts0, _counts(fa))))
    check(np.isfinite(float(metrics["loss"])), "selective remat loss")
    sel_layer = (cfg.n_layers,) * 3
    check(all(c == sel_layer for c in sel_counts),
          f"selective remat launches per step (K1, K2, K3) {sel_counts}, "
          f"expected {sel_layer}")
    print(f"train: selective remat: {SELECTIVE_STEPS} steps "
          f"{[round(t * 1e3, 2) for t in sel_s]} ms, mean "
          f"{statistics.mean(sel_s) * 1e3:.2f} ms/step (full: "
          f"{mean_s * 1e3:.2f}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
          f"(K1, K2, K3) {sel_layer} per step, loss "
          f"{float(metrics['loss']):.5f}")
    model.cfg = cfg

    _profile(torch, lambda: step(state, batch),
             f"one training step of {TRAIN_PRESET} (full remat)", 20,
             expect=WGMMA_KERNELS)
    del state, model, step, sel_step, metrics, batch
    torch.cuda.empty_cache()
    return counts, {"ms_per_step": mean_s * 1e3, "tokens_per_s": tokens_s,
                    "mfu": mfu, "peak_gib": peak_full / 2**30,
                    "losses": losses, "fingerprints": prints}


def phase_mesh_training(torch, mesh, ref):
    """Phase 5's recipe through prepare_mesh's 1-rank mesh, under the JAX
    package's single-chip rules (all None) and under tp_fsdp_rules():
    init_train_state and make_train_step with the mesh, launches per step,
    each step's loss and the first update against phase 5's (``ref``), and
    times beside phase 5's. Returns the (K1, K2, K3) launches."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import tp_fsdp_rules
    from ray_tpu_torch.parallel import train_step as ts

    cfg = gpt.config(TRAIN_PRESET, **TRAIN_OVERRIDES)
    batch = _train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, 0, DEVICE)
    per_layer = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    total = [0, 0, 0]
    for rules_name, rules in (("rules all None (bench.py)", _all_rules()),
                              ("tp_fsdp_rules()", tp_fsdp_rules())):
        base = torch.cuda.memory_allocated()
        opt = ts.memory_efficient_optimizer(learning_rate=1e-4)
        t0 = time.perf_counter()
        state = ts.init_train_state(cfg, mesh, rules, opt, seed=0,
                                    device=DEVICE)
        step = ts.make_train_step(cfg, mesh, rules, opt)
        torch.cuda.synchronize()
        state_gib = (torch.cuda.memory_allocated() - base) / 2**30
        print(f"mesh: {TRAIN_PRESET} under {rules_name}: state initialised "
              f"in {time.perf_counter() - t0:.2f} s, {state_gib:.2f} GiB "
              f"(above the {base / 2**30:.2f} GiB held before it)")
        model = state["params"]
        _check_placed(model, rules_name)
        losses, step_s, per_step, diffs = [], [], [], []
        _zero_counts(fa)
        for i in range(MESH_WARMUP + MESH_STEPS):
            if i == MESH_WARMUP:
                torch.cuda.reset_peak_memory_stats()
            counts0 = _counts(fa)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append(tuple(b - a for a, b in zip(counts0, _counts(fa))))
            losses.append(float(metrics["loss"]))
            mine = _fingerprint(torch, {n: p.to_local() for n, p in
                                        model.named_parameters()})
            diffs.append(float((mine - ref["fingerprints"][i]).abs().max()))
            if i == 0:
                check(torch.equal(mine, ref["fingerprints"][0]),
                      f"{rules_name}: after the first step a parameter's "
                      f"fp64 sum or norm differs from phase 5's")
        peak = torch.cuda.max_memory_allocated() - base
        counts = _counts(fa)
        total = [t + c for t, c in zip(total, counts)]
        check(all(c == per_layer for c in per_step),
              f"{rules_name}: launches per step (K1, K2, K3) {per_step}, "
              f"expected {per_layer}")
        rel = [abs(a / b - 1) for a, b in zip(losses, ref["losses"])]
        check(np.isfinite(losses).all() and max(rel) <= MESH_LOSS_RTOL,
              f"{rules_name}: losses {losses} against phase 5's "
              f"{ref['losses'][:len(losses)]}")
        timed = step_s[MESH_WARMUP:]
        mean_s = statistics.mean(timed)
        tokens_s = TRAIN_BATCH * TRAIN_SEQ / mean_s
        mfu = tokens_s * gpt.flops_per_token(cfg) / PEAK_FLOPS["bfloat16"]
        print(f"mesh: {rules_name}: losses {losses}; max rel dloss against "
              f"phase 5's steps {max(rel):.3e} (bound {MESH_LOSS_RTOL:.0e}); "
              f"first update left every parameter's fp64 sum and norm "
              f"equal to phase 5's; max |d(sum, norm)| per step "
              f"{[f'{d:.3e}' for d in diffs]}")
        print(f"mesh: {rules_name}: {MESH_STEPS} timed steps "
              f"{[round(t * 1e3, 2) for t in timed]} ms; mean "
              f"{mean_s * 1e3:.2f} ms/step (phase 5: "
              f"{ref['ms_per_step']:.2f}), {tokens_s:.1f} tokens/s "
              f"(phase 5: {ref['tokens_per_s']:.1f}), MFU {mfu:.2%} (phase "
              f"5: {ref['mfu']:.2%}), peak memory {peak / 2**30:.2f} GiB "
              f"(phase 5: {ref['peak_gib']:.2f}), "
              f"{(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB of "
              f"state held between steps ({state_gib:.2f} after init); "
              f"launches (K1, K2, K3) {counts} = {per_layer} per step")
        # Memory of the loss and its gradients alone, as phase 5 prints it:
        # FSDP2 gathers and reduces them; the step's optimizer does not run.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        loss, _ = gpt.loss_fn(model, batch["tokens"], batch["targets"])
        loss.backward()
        torch.cuda.synchronize()
        print(f"mesh: {rules_name}: loss and gradients peak at "
              f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB "
              f"above the {(held - base) / 2**30:.2f} GiB of state")
        for p in model.parameters():
            p.grad = None
        del loss
        _profile(torch, lambda: step(state, batch),
                 f"one training step of {TRAIN_PRESET} on the mesh, "
                 f"{rules_name}", 12, expect=WGMMA_KERNELS)
        del state, model, step, metrics
        gc.collect()
        torch.cuda.empty_cache()
    return tuple(total)


def phase_small_training(torch):
    """gpt-micro (fp32) through the train step: K1-K3 on the card against
    the plain versions on the CPU, 3 steps of AdamW from the same weights
    and batches, at accumulation 1 and 2."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import train_step as ts
    cfg = gpt.config("gpt-micro", attn_impl="flash")
    for accum in (1, 2):
        results = {}
        for device in ("cpu", DEVICE):
            opt = ts.default_optimizer(1e-3, warmup_steps=1)
            model = gpt.init(cfg, torch.Generator().manual_seed(0), "cpu")
            if device != "cpu":
                card = gpt.GPT(cfg, device=device)
                card.load_state_dict(model.state_dict())
                model = card
            state = {"params": model,
                     "opt_state": opt.init(dict(model.named_parameters()),
                                           gpt.leaf_groups(model)),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=device)}
            step = ts.make_train_step(cfg, optimizer=opt, accum_steps=accum)
            batches = [_train_batch(torch, cfg, 4, 256, 10 + i, device)
                       for i in range(3)]
            # The first step's gradients, before the optimizer scales them.
            loss, _ = gpt.loss_fn(model, batches[0]["tokens"],
                                  batches[0]["targets"])
            names = [n for n, _ in model.named_parameters()]
            grads = torch.autograd.grad(loss, list(model.parameters()))
            grads = {n: g.cpu() for n, g in zip(names, grads)}
            losses = []
            for b in batches:
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
            results[device] = (np.array(losses), {
                n: p.detach().cpu() for n, p in model.named_parameters()},
                grads)
        (ref_l, ref_p, ref_g), (got_l, got_p, got_g) = (results["cpu"],
                                                        results[DEVICE])
        grad_err = max(float((got_g[n] - ref_g[n]).norm() / ref_g[n].norm())
                       for n in ref_g)
        print(f"gpt-micro fp32 gradients, card vs CPU: max over tensors of "
              f"|dgrad| / |grad| {grad_err:.3e} (bound "
              f"{MICRO_GRAD_RTOL:.0e})")
        check(grad_err <= MICRO_GRAD_RTOL,
              "gpt-micro gradients on the card disagree with the CPU")
        p0 = dict(gpt.init(cfg, torch.Generator().manual_seed(0), "cpu")
                  .named_parameters())
        loss_err = float(np.abs(got_l / ref_l - 1).max())
        update_err = max(float((got_p[n] - ref_p[n]).norm()
                               / (ref_p[n] - p0[n].detach()).norm())
                         for n in ref_p)
        abs_err = max(float((got_p[n] - ref_p[n]).abs().max()) for n in ref_p)
        print(f"gpt-micro fp32 train, accumulation {accum}: losses "
              f"{got_l.round(6).tolist()}; card vs CPU max rel dloss "
              f"{loss_err:.3e} (bound {MICRO_LOSS_RTOL:.0e}), max over "
              f"tensors of |dparam| / |update| {update_err:.3e} (bound "
              f"{MICRO_UPDATE_RTOL:.0e}), max |dparam| {abs_err:.3e}")
        check(loss_err <= MICRO_LOSS_RTOL and update_err <= MICRO_UPDATE_RTOL,
              f"gpt-micro training on the card disagrees with the CPU at "
              f"accumulation {accum}")


def _llama_step(torch, llama, model, params, opt, opt_state, batch):
    """One Llama training step, composed as the JAX package's tests compose
    theirs (it has no Llama train step): ``loss_fn``, its gradients, the
    optimizer's update in place and ``apply_updates`` → (the optimizer's
    state, metrics)."""
    from ray_tpu_torch.parallel import optim
    loss, metrics = llama.loss_fn(model, batch["tokens"], batch["targets"])
    grads = torch.autograd.grad(loss, list(params.values()))
    with torch.no_grad():
        updates, opt_state = opt.update(dict(zip(params, grads)), opt_state,
                                        params)
        optim.apply_updates(params, updates)
    return opt_state, metrics


def _fingerprint(torch, params):
    """Each tensor's fp64 sum and L2 norm, on the card (a copy of 8 B fp32
    parameters would not fit beside the step); no autograd graph, which
    would hold the parameters for as long as the fingerprint lives."""
    with torch.no_grad():
        return torch.stack([torch.stack((
            torch.sum(p, dtype=torch.float64),
            torch.linalg.vector_norm(p, dtype=torch.float64)))
            for p in params.values()]).cpu()


def phase_llama_training(torch):
    """llama3-8b at full width and depth: batch 1 x 4096, flash attention,
    remat, the unchunked loss and Adafactor (lr 1e-4 after 100 warm-up
    steps, so 0 at step 0)."""
    from dataclasses import replace

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import train_step as ts

    cfg = llama.config(LLAMA_PRESET, attn_impl="flash", remat=True)
    opt = ts.memory_efficient_optimizer(learning_rate=1e-4)
    t0 = time.perf_counter()
    model = llama.init(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                       DEVICE)
    params = dict(model.named_parameters())
    opt_state = opt.init(params, llama.leaf_groups(model))
    batch = _train_batch(torch, cfg, LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ, 0,
                         DEVICE)
    before = _fingerprint(torch, params)
    torch.cuda.synchronize()
    print(f"train: {LLAMA_PRESET} ({cfg.num_params() / 1e9:.3f} B params, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.kv_heads}), batch {LLAMA_TRAIN_BATCH} x "
          f"{LLAMA_TRAIN_SEQ}, flash attention, remat, unchunked loss, "
          f"Adafactor lr 1e-4; state initialised in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    n_steps = LLAMA_WARMUP + LLAMA_STEPS
    losses, step_s, per_step = [], [], []
    _zero_counts(fa)
    for i in range(n_steps):
        if i == LLAMA_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        counts0 = _counts(fa)
        t0 = time.perf_counter()
        opt_state, metrics = _llama_step(torch, llama, model, params, opt,
                                         opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(tuple(b - a for a, b in zip(counts0, _counts(fa))))
        losses.append(float(metrics["loss"]))
        if i == 0:
            check(torch.equal(_fingerprint(torch, params), before),
                  "the first update changed a parameter")
    counts = _counts(fa)
    peak = torch.cuda.max_memory_allocated()

    per_layer = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    check(all(c == per_layer for c in per_step),
          f"launches per step (K1, K2, K3) {per_step}, expected {per_layer}")
    check(np.isfinite(losses).all()
          and abs(losses[0] - LLAMA_LOSS0) <= LLAMA_LOSS0_TOL,
          f"step-0 loss {losses[0]} is not within {LLAMA_LOSS0_TOL} of "
          f"{LLAMA_LOSS0}")
    timed = step_s[LLAMA_WARMUP:]
    mean_s = statistics.mean(timed)
    tokens_s = LLAMA_TRAIN_BATCH * LLAMA_TRAIN_SEQ / mean_s
    # The attention term at the trained length, not the preset's 8192.
    flops = llama.flops_per_token(replace(cfg, max_seq_len=LLAMA_TRAIN_SEQ))
    mfu = tokens_s * flops / PEAK_FLOPS["bfloat16"]
    print(f"train: {LLAMA_PRESET}: losses {[round(x, 5) for x in losses]}; "
          f"first update left every parameter's fp64 sum and norm unchanged")
    print(f"train: {LLAMA_PRESET}: {LLAMA_STEPS} timed steps: "
          f"{[round(t * 1e3, 2) for t in timed]} ms; mean {mean_s * 1e3:.2f}"
          f" ms/step (std {statistics.pstdev(timed) * 1e3:.2f}), "
          f"{tokens_s:.1f} tokens/s, model FLOPs {flops:.4e}/token (S = "
          f"{LLAMA_TRAIN_SEQ}), MFU {mfu:.2%} of the 989 TFLOP/s bf16 peak; "
          f"peak memory {peak / 2**30:.2f} GiB")
    print(f"train: {LLAMA_PRESET}: launches over {n_steps} steps (K1, K2, "
          f"K3) {counts} = {per_layer} per step")
    _profile(torch, lambda: _llama_step(torch, llama, model, params, opt,
                                        opt_state, batch),
             f"one training step of {LLAMA_PRESET}", 20,
             expect=WGMMA_KERNELS)
    del model, params, opt_state, metrics, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_llama_small(torch):
    """llama-micro (fp32, 8 query heads over 4 KV heads: the fp32 kernels'
    GQA path) on the card against the CPU from the same weights and
    batches: logits, the first gradients, and 3 Adafactor steps (lr 0 at
    step 0)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts
    cfg = llama.config("llama-micro", attn_impl="flash")
    results = {}
    for device in ("cpu", DEVICE):
        model = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
        if device != "cpu":
            card = llama.Llama(cfg, device=device)
            card.load_state_dict(model.state_dict())
            model = card
        params = dict(model.named_parameters())
        opt = ts.memory_efficient_optimizer(1e-2, warmup_steps=1)
        opt_state = opt.init(params, llama.leaf_groups(model))
        batches = [_train_batch(torch, cfg, 4, 256, 20 + i, device)
                   for i in range(3)]
        with torch.inference_mode():
            logits = model(batches[0]["tokens"]).cpu()
        loss, _ = llama.loss_fn(model, batches[0]["tokens"],
                                batches[0]["targets"])
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = {n: g.cpu() for n, g in zip(params, grads)}
        losses = []
        for b in batches:
            opt_state, metrics = _llama_step(torch, llama, model, params, opt,
                                             opt_state, b)
            losses.append(float(metrics["loss"]))
        results[device] = (logits, grads, np.array(losses), {
            n: p.detach().cpu() for n, p in params.items()})
    (ref_x, ref_g, ref_l, ref_p), (got_x, got_g, got_l, got_p) = (
        results["cpu"], results[DEVICE])
    logit_err = float((got_x - ref_x).abs().max())
    grad_err = max(float((got_g[n] - ref_g[n]).norm() / ref_g[n].norm())
                   for n in ref_g)
    p0 = dict(llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
              .named_parameters())
    loss_err = float(np.abs(got_l / ref_l - 1).max())
    update_err = max(float((got_p[n] - ref_p[n]).norm()
                           / (ref_p[n] - p0[n].detach()).norm())
                     for n in ref_p)
    print(f"llama-micro fp32, card kernels vs CPU plain versions: max|dlogit|"
          f" {logit_err:.3e} (bound {MICRO_TOL:.0e}); max over tensors of "
          f"|dgrad| / |grad| {grad_err:.3e} (bound {MICRO_GRAD_RTOL:.0e}); "
          f"3 Adafactor steps, losses {got_l.round(6).tolist()}, max rel "
          f"dloss {loss_err:.3e} (bound {MICRO_LOSS_RTOL:.0e}), max over "
          f"tensors of |dparam| / |update| {update_err:.3e} (bound "
          f"{MICRO_UPDATE_RTOL:.0e})")
    check(bool(((got_x - ref_x).abs() <= MICRO_TOL + MICRO_TOL * ref_x.abs())
               .all()), "llama-micro logits on the card disagree with the CPU")
    check(grad_err <= MICRO_GRAD_RTOL,
          "llama-micro gradients on the card disagree with the CPU")
    check(loss_err <= MICRO_LOSS_RTOL and update_err <= MICRO_UPDATE_RTOL,
          "llama-micro training on the card disagrees with the CPU")


def _timed(phase, fn, *args):
    """``fn(*args)``, printing the phase's seconds."""
    t0 = time.perf_counter()
    result = fn(*args)
    print(f"phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)
    return result


def kernel_times(root):
    """Phase 3 alone (K1-K3 checked and timed) for the ray_tpu_torch of
    another checkout under ``root``, for example a parent commit unpacked
    under build/, with this script's inputs and timers: two trees are timed
    alike in one call. Prints the kernel rows and no result line."""
    torch, _ = phase_environment(pathlib.Path(root).resolve())
    k1 = phase_kernel_check(torch)
    k2, k3 = phase_backward_check(torch)
    print(json.dumps({"kernel_times": {"flash_fwd": k1, "flash_bwd_dq": k2,
                                       "flash_bwd_dkv": k3}}))


def main():
    if sys.argv[1:2] == ["--kernel-times"] and len(sys.argv) == 3:
        return kernel_times(sys.argv[2])
    check(len(sys.argv) == 1, "usage: chip_smoke.py [--kernel-times ROOT]")
    t_start = time.perf_counter()
    torch, name = phase_environment()
    try:
        kernels = _main_phases(torch)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def _main_phases(torch):
    """Phases 2-5d; returns the kernels line's rows."""
    from ray_tpu_torch.parallel import MeshConfig
    from ray_tpu_torch.parallel.mesh import mesh_sizes
    from ray_tpu_torch.train.torch import prepare_mesh

    _timed("2", phase_build)
    k1 = _timed("3 (K1)", phase_kernel_check, torch)
    k2, k3 = _timed("3 (K2, K3)", phase_backward_check, torch)
    k1_serve = _timed("4", phase_serving, torch)
    _timed("4 (gpt-micro)", phase_small_reference, torch)
    k1_llama_serve, buf, logits = _timed("4b", phase_llama_serving, torch)
    # A 1-rank NCCL process group and mesh, as a train worker builds them.
    mesh = prepare_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1, ep=1))
    print(f"mesh: {torch.distributed.get_backend()} group of "
          f"{torch.distributed.get_world_size()}, mesh "
          f"{mesh_sizes(mesh)}")
    k1_llama_mesh = _timed("4c", phase_llama_mesh_forward, torch, mesh, buf,
                           logits)
    del buf, logits
    (k1_train, k2_train, k3_train), ref = _timed("5", phase_training, torch)
    k1_mesh, k2_mesh, k3_mesh = _timed("5d", phase_mesh_training, torch,
                                       mesh, ref)
    _timed("5 (gpt-micro)", phase_small_training, torch)
    k1_llama, k2_llama, k3_llama = _timed("5b", phase_llama_training, torch)
    _timed("5c", phase_llama_small, torch)
    src = "ray_tpu_torch/ops/csrc/"
    ref = "ray_tpu/ops/flash_attention.py:"
    return [
        {"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
         "replaces": ref + "37",
         "launches": (k1_serve + k1_llama_serve + k1_llama_mesh + k1_train
                      + k1_mesh + k1_llama), **k1},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": src + "flash_bwd.cu", "replaces": ref + "88",
         "launches": k2_train + k2_mesh + k2_llama, **k2},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": src + "flash_bwd.cu", "replaces": ref + "131",
         "launches": k3_train + k3_mesh + k3_llama, **k3}]


if __name__ == "__main__":
    main()

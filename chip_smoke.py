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
   training shapes, llama3-8b's (32 query heads over 8 KV heads),
   gpt-moe-8x410m's (16 heads of 64) and gpt-410m's training shape (18 x
   1024, 16 heads of 64), and in fp32 at head dim 64 and S 1024; then K2
   and K3 (the backward: dq, and dk/dv) against theirs, at an fp32 GQA
   shape, at the four models' training shapes and in fp32 at head dim
   64. Times of each kernel (per
   call through its wrapper, and per launch in a stream of launches,
   which hides the host's share), its plain version and PyTorch's
   ``scaled_dot_product_attention`` forward or backward (a yardstick only,
   never called by the port; ``enable_gqa`` under GQA) beside the least
   time the card could take, and the rates the kernel reached.
4. Serving: gpt-1.3b at full width (random weights from a seeded
   generator, bf16 compute, flash attention) answers 8 requests, arriving
   while it decodes, through the port's ContinuousBatcher; later requests
   must join a running batch, and K1 must run once per layer per step.
   Then the same step under dot attention, and gpt-micro and gpt-moe-tiny
   (4 experts, top-2) on the card against the CPU, check what comes out.
   4d: gpt-moe-8x410m at full width and depth is served the same way, K1
   at head dim 64; the share of tokens whose top-2 experts differ between
   the flash, dot and fp32 runs, each routing itself, and their logit gaps
   are printed, not held; the dot and fp32 runs then replay the flash
   run's routes and their logits are held to gpt-1.3b's bound; and the
   fp32 run's first MoE layer, on its own input and routing itself, is
   held to an index-based version of the layer written apart from the
   port's (top-2 experts and kept assignments exactly, output and aux term
   to fp32 summation order). 4b: llama3-8b at full width and
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
   phase 5's, and a profile of one step. 5e: sharded checkpoints: phase
   5's recipe on the mesh under ``tp_fsdp_rules()`` takes 2 steps, is
   saved in the JAX package's format (``save_train_state``) into a
   temporary ``file://`` directory, and takes 2 more as the reference;
   then a state of another seed under the same rules resumes from
   ``latest_checkpoint`` (``load_for_rank``), and one under the all-None
   rules (``restore_on_mesh``, the specs change): each must hold the saved
   fp64 sums and norms of every parameter and optimizer tensor, and its 2
   steps must give the reference's losses and fingerprints bit for bit.
   The bytes on disk, save and restore seconds and GB/s (and the save's
   layout on the host and one crc32 pass timed alone), the directory's
   free space and the host's peak RSS during the save are printed; the
   directory is deleted. 5f: gpt-moe-8x410m at full width and depth takes
   8 steps of phase 5's recipe (48/24/24 launches a step, the step-0 loss,
   the first update, ms per step, MFU by the active experts' FLOPs, peak
   memory, a profile with the MoE layer's ranges). 5g: on the 1-rank mesh,
   5f's steps under ``tp_fsdp_rules()`` (experts over an ep of one) must
   be 5f's bit for bit; then gpt-1.3b placed by
   ``context_parallel_rules()`` runs forward on phase 4's last buffer
   under ``attn_impl`` "ring" and "ulysses" (over an sp of one), each
   within the bf16 bound of "dot" and launching no kernel.
   4e (after 5c): the diffusion UNet served through the port's
   ``@serve.batch``, as ``examples/serve_diffusion.py`` deploys it:
   ddpm-cifar at bench.py's program (64 concurrent requests of one x_T
   each, 50 DDIM steps, eta 0) and sd-base (8 requests), bf16 compute over
   seeded random fp32 weights; the requests must coalesce into one sampler
   call; images/s and ms per DDIM step; the same x_T sampled in fp32 on
   the card and the bf16 images held to it; a profile of one forward
   (convolutions, GEMMs, the rest); unet-tiny in fp32 on the card against
   the CPU (one forward, a 10-step sample). 4f (after 4e): gpt-1.3b
   served through a deployment (``serve.run``) whose replica runs in a
   worker process on a 0.5 GPU lease of the card, phase 4's decode engine
   inside: (a) phase 4's 8 prompts at phase 4's staggered arrival through
   a ``DeploymentHandle``, every request's tokens bit-equal to phase 4's,
   one joining a running batch, K1 once per layer per step counted in the
   replica's process; (b) a new version deployed while 8 more requests are
   in flight (the new replica starts beside the old one, which drains),
   every one answered with phase 4's tokens; (c) one request through the
   HTTP proxy; (d) ``serve.delete``, after which the card's free memory is
   back within 1 GiB of its value before 4f. ms per step and tokens/s
   beside phase 4's, the replica's start, the redeploy's seconds, the
   requests' p50/p99 latency. 4g: the ported
   ``examples/serve_diffusion.py`` through its ``main()`` at ddpm-cifar
   (8 requests, 10 DDIM steps, its replica in this process): 8 finite
   images of the preset's shape from at most 2 batches, the first batch
   bit-equal to ``ddim_sample`` called here from the same seeds, and this
   process's allocated memory back within 64 MiB after its shutdown;
   images/s and ms per DDIM step. 4h: ``python -m
   ray_tpu_torch.scripts.cli devices`` names the card. 5h: ddpm-cifar (batch 128),
   vit-b16 (64 images of 224x224), bert-base (32 x 512, 15% masked) and
   t5-base (16 x 512 + 128) trained with AdamW at weight decay 0, 2
   warm-up and 4 timed steps each: ms per step, items/s, peak memory, the
   step-0 loss held to its random-init value, every parameter the loss
   reaches moved, a profile of one step; then vit-tiny, bert-tiny and
   t5-tiny in fp32 on the card against the CPU (forward and first
   gradients). None of these models launches K1-K3. 5i: the same four on
   the 1-rank mesh, placed by ``init(..., mesh=, rules=)`` (ViT, BERT and
   T5 under ``tp_fsdp_rules()``, the UNet under ``dp_rules()``; FSDP2 and
   DTensor parameters) from 5h's seed, their weights 5h's; 1 warm-up and 2
   timed steps (5h's first 3 held) composed as a user composes them (the
   loss inside
   ``registered_mesh``, backward, ``average_replicated_grads``, AdamW):
   ViT's and BERT's losses and first update 5h's bit for bit; the UNet's
   and T5's step-0 loss bit-equal, later losses within 1e-4 and the first
   update within 2 lr of 5h's (FSDP2 sums the gradient of a tensor that
   several of its units read in another association; ``ZOO_MESH_EXACT``);
   ms per step, items/s, peak memory and a step's device time beside
   5h's. Then t5-base's state is saved and resumed by both routes, each
   resumed step bit-equal to the uninterrupted one (save and restore
   seconds printed; the directory deleted). 5k: the same four placed by
   ``context_parallel_rules()`` on the 1-rank mesh (BERT's and T5's
   sequence on ``sp``, an axis of one rank; ViT's and the UNet's images
   never split) from 5h's seed, their steps composed as in 5i
   (``average_replicated_grads`` with the model's ``batch_spec``): the
   losses and first update 5i's bit for bit for ``ZOO_MESH_EXACT``, else
   by 5i's bounds; the operators a step dispatches equal to 5i's, by
   name and argument shapes (``_dispatched``); ms per step, items/s and
   peak memory beside 5i's.
   3b (after phase 3): the lookups as the JAX package's ``jnp.take`` and
   ``jnp.take_along_axis`` take them, on the card at bert-base's
   (30522 x 768) and gpt-410m's (50304 x 1024) tables: ids and targets -1,
   V and -V-1 read the wrapped row or logit bit for bit and NaN out of
   range, the gradient lands on the wrapped rows only, and no
   device-side assert fires. 5j (after 5e): gpt-410m at full width and
   depth with the JAX package's recipe for it (batch 18 x 1024, flash,
   selective remat, loss_chunk 6144, default_optimizer(1e-4)): the first
   gradients of full and selective remat from one state (step-0 loss
   bit-equal, global norm within 1e-5); then full remat, selective remat,
   and selective remat on the 1-rank mesh under the all-None rules and
   under ``tp_fsdp_rules()``, 2 warm-up and 4 timed steps each from seed
   0: (48, 24, 24) launches a step under full remat, (24, 24, 24) under
   selective, the mesh runs' step-0 loss bit-equal to the selective
   step's without a mesh and later losses within 1e-5; ms per step,
   tokens/s, MFU and peak memory of each.
   5l: the gang. Phase 5's recipe through ``TorchTrainer.fit``
   (``ScalingConfig(num_workers=1, use_gpu=True, runtime_env=
   {"worker_process": True})``) on the port's own task/actor runtime: the
   worker process, which sees only the card of its lease, starts its own
   NCCL group of one and trains 5 steps, saving a checkpoint after step 3;
   a second fit resumes from it and reports steps 4 and 5 only. Every
   loss bit-equal to phase 5's same step, (48, 24, 24) launches a step in
   the worker (counted there and added to the kernels line), the worker's
   pid another than this one's and its device cuda:0; ms per step with
   the gang beside phase 5's, the worker's start (fit to its loop's first
   line), its state's initialisation, save and restore seconds.
   5m: the training side of AIR on the runtime, at gpt-410m (16 x
   1024, flash, selective remat, loss_chunk 2048). (a) The port's GPT-J
   example through its ``main()`` in one worker process on the card:
   (24, 24, 24) launches a step, finite losses, ms per step, tokens/s and
   approx_mfu. (b) The same recipe through ``TorchTrainer`` with its
   batches from ``iter_torch_batches`` of the rank's Data shard (5m(d)),
   losses bit-equal to (a)'s (3 steps each); ``session.report_sharded``
   after steps 2 and 3, committed by the trainer's executor; a second fit
   resumed from step 2 bit-equal to the first; state bytes, save and
   restore seconds, the worker's peak RSS. (c)
   ``TorchPredictor.from_checkpoint`` of the final checkpoint in this
   process: per-sequence fp64 logit sums and
   max abs bit-equal to the worker's; ``BatchPredictor`` over 8
   sequences bit-equal to the predictor's. (e) ``util.collective``
   between two worker-process actors on 0.5 GPU leases of the card:
   allreduce (star and ring path) and allgather of float64 CUDA tensors,
   numpy's values, the JAX package's dtypes; a bfloat16 tensor reduced
   as its float32 values.
   5n: Tune over ``TorchTrainer``: a ``Tuner`` of two trials of phase 5's
   recipe (``_gang_loop``, 5 steps) at phase 5's lr and a quarter of it,
   each trial's rank a worker process on half the card
   (``resources_per_worker={"GPU": 0.5}``), both at once
   (``max_concurrent_trials=2``), stopped by ``stop={"training_iteration":
   3}``: (a) both workers on card 0 with overlapping steps; (b) the
   phase-5-lr trial's losses phase 5's first three bit for bit, the other
   trial's first loss phase 5's first; (c) each trial's last result at
   iteration 3, no errors, the best result the lower final loss; (d) after
   ``fit()`` both worker processes gone, the runtime's GPU free and the
   card's free memory back within 1 GiB. Each trial's start, ms per step
   and launches (added to the kernels line).
   5o: RLlib's PPO learner on the card. It prints whether
   gymnasium imports (the route). On both routes: one ``PPO._sgd`` of the
   tuned cartpole-ppo recipe (1024 rows, 10 epochs of minibatches of 256,
   lr 1e-3) on the card and on the CPU from the same parameters, per
   minibatch and fused (the batch sent to the card once), within 1e-4; a
   ``LearnerGroup`` with two remote learners, which lease half the card
   each, its gradients and update the local learner's; the learner's
   parameters on the card; cartpole-ppo trains 15 iterations with its
   learner on the card and must pass tests/test_rllib.py's bar (last
   episode_reward_mean > 45 and > 2.5 x the first), then saves and
   restores with the same weights and greedy actions. Its environment is
   gymnasium's CartPole-v1, or without gymnasium the same dynamics in
   numpy (``_CartPole``). With gymnasium, the ported multi-agent
   example's ``main()`` also learns its two opposing policies.
   5p (last): RLlib's other learners on the card, at the tuned examples'
   widths and batches (``RLLIB_UPDATES``' note). (a) DQN (prioritized
   3-step rows), SAC, CQL (its penalty in the critic's loss), TD3, A2C,
   PG, IMPALA and APPO (V-trace), BC, MARWIL and ES's theta step, each
   built on the CPU and on the card from one learner state
   (``learner_state``), take the same updates on the same batch and noise
   (drawn on the host): every state and metric within 1e-4 of the CPU's,
   the card learner's parameters on the card, each update's ms on both.
   (b) pendulum-sac trains 4 iterations (3 x 256 updates) on ``_Pendulum``
   (gymnasium's Pendulum-v1 in numpy, or gymnasium's where installed):
   finite losses, every action within +-2; cartpole-dqn trains 6
   iterations with epsilon annealing, then is saved and restored with the
   same weights and greedy actions; s per iteration of each.
6. One JSON line of kernels (ms and library_ms per call, launch_ms and
   library_launch_ms per launch, at gpt-1.3b's shapes; the same at
   llama3-8b's under "llama3_8b", gpt-moe-8x410m's under
   "gpt_moe_8x410m" and gpt-410m's training shape under "gpt_410m"); the
   last line is the result.

``python3 chip_smoke.py --kernel-times ROOT`` runs phase 3 alone for the
``ray_tpu_torch`` of the checkout at ROOT (its kernels build under
ROOT/build/), so that two trees' kernels are timed by one method in one
call; it prints no result line. ``python3 chip_smoke.py --phases
zoo,air,rllib`` runs phases 1 and 2 and then the named groups of later
phases alone ("zoo": 5h, 5i, 5k; "air": 5m; "rllib": 5o, 5p), with their
checks; it prints no result line either.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import zlib

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
# 5e: steps before the save, and after it (the reference, and each resume).
CKPT_STEPS = 2
# Phase 5l: phase 5's recipe through TorchTrainer.fit in one worker
# process, a checkpoint after GANG_SAVE_AT of GANG_STEPS steps and a resume
# from it. Its losses are phase 5's bit for bit: one process runs the same
# kernels on the same inputs in the same order as another.
GANG_STEPS, GANG_SAVE_AT = 5, 3
# Phase 5n: Tune over TorchTrainer. Two trials of phase 5's recipe (each a
# worker process on TUNE_GPUS of the card, both at once) at phase 5's lr
# and a quarter of it, stopped by Tune after TUNE_STOP of the loop's
# GANG_STEPS steps. The phase-5-lr trial's losses are phase 5's bit for
# bit (as 5l's): the other trial shares the card but no tensor.
TUNE_GPUS = 0.5
TUNE_LRS = (1e-4, 1e-4 / 4)
TUNE_STOP = 3
# Free card memory after the Tuner's fit against before 5n: the trials'
# worker processes and their states go with them (4f(d)'s bound).
TUNE_FREE_SLACK = 1 << 30
# Phase 5o: RLlib's learner on the card. The tuned cartpole-ppo
# (ray_tpu/rllib/tuned_examples/__init__.py:34-40: 2 rollout workers, lr
# 1e-3, batch 1024, 10 SGD iterations, minibatch 256, seed 7) trains
# RLLIB_ITERS iterations with the learner on the card and must pass
# tests/test_rllib.py:61-92's bar; its recipe's _sgd runs once on the card
# and once on the CPU from the same parameters and batch, on both
# schedules. fp32 with TF32 off: the weights after 40 Adam steps of lr
# 1e-3 differ by summation order only, which Adam's division by |g| grows
# step by step; a wrong gradient moves a weight by O(lr) at once.
RLLIB_ITERS = 15
RLLIB_LR, RLLIB_BATCH, RLLIB_SGD_ITERS, RLLIB_MINIBATCH = 1e-3, 1024, 10, 256
RLLIB_SGD_TOL = 1e-4
# 5o's LearnerGroup: two remote learners, which the group puts on half the
# card each (the share follows from the learner count).
RLLIB_REMOTE_LEARNERS, RLLIB_LEARNER_SHARE = 2, 0.5
# Phase 5p: RLlib's other learners on the card, at the tuned examples'
# widths and batches (ray_tpu/rllib/tuned_examples/__init__.py), nothing
# cut: cartpole-dqn (:53-65: lr 8e-4, batch 64, 64x64, dueling double Q,
# target sync every 128 steps, epsilon over 3000 steps, 32 updates an
# iteration after 500 samples; 5p(a) adds prioritized 3-step rows),
# pendulum-sac (:122-135: lr 3e-4, batch 256, 256x256, tau 0.005, 256
# updates an iteration after 500 samples; CQL's penalty at its widths),
# cartpole-a2c (:44-51: lr 2e-3, batch 512); the learners without a tuned
# example at their configs' defaults (TD3 and the offline ones batch 256,
# PG 1024 as tests/test_rllib.py trains it, IMPALA and APPO 512, ES 2
# workers of 10 pairs). (a) Each learner's update runs on the card and on
# the CPU from the same learner state, batch and noise (noise drawn on the
# host), RLLIB_UPDATES updates each, held to RLLIB_SGD_TOL as 5o's are.
# SAC's and CQL's actor head is scaled by RLLIB_HEAD_SCALE there: on a
# row whose tanh saturates, their log-probability's log(1 - a^2 + 1e-6)
# turns the card's and the CPU's last ulp of tanh into ~1e-1 (tests/
# test_torch_rllib_q.py, HEAD_SCALE). (b) pendulum-sac trains
# RLLIB_SAC_ITERS iterations on _Pendulum and cartpole-dqn RLLIB_DQN_ITERS
# on _CartPole (or gymnasium's environments where it is installed), their
# learners on the card; then cartpole-dqn is saved and restored.
RLLIB_UPDATES = 2
RLLIB_HEAD_SCALE = 0.25
RLLIB_SAC_ITERS, RLLIB_DQN_ITERS = 4, 6
# Phase 5m: the training side of AIR on the runtime at gpt-410m, with the
# JAX package's example's preset and sizes (examples/gptj_finetune.py:
# 103-110: batch 16 x 1024, flash attention, selective remat, loss_chunk
# 2048; its default_optimizer at lr 1e-5 over AIR_STEPS steps). Widths
# and depth uncut; the run is cut to 3 steps (from 4), and the resumed
# fit saves nothing (no check reads its save). The example runs through
# its main() (5m(a)); the same recipe is fed by Data, saved by
# session.report_sharded after AIR_SAVE_AT and resumed (5m(b), 5m(d));
# TorchPredictor and BatchPredictor score
# AIR_PROBE_ROWS sequences on its checkpoint (5m(c), 5m(d)); and two
# actors on halves of the card allreduce and allgather CUDA tensors below
# and above util.collective's _INLINE_LIMIT of 512 KiB (5m(e)).
AIR_PRESET = "gpt-410m"
AIR_BATCH, AIR_SEQ = 16, 1024
AIR_OVERRIDES = dict(attn_impl="flash", remat_policy="selective",
                     loss_chunk=2048)
AIR_LR, AIR_STEPS, AIR_SAVE_AT = 1e-5, 3, (2, 3)
AIR_PROBE_ROWS = 4
AIR_COLLECTIVE_SIZES = (1024, 1 << 17)  # float64: 8 KiB and 1 MiB
# Phase 5j: gpt-410m (ray_tpu/models/gpt.py:118-120: 24 layers, d_model
# 1024, 16 heads of 64, d_ff 4096, vocab 50304) at the JAX package's own
# recipe for it (bench.py:2473-2478): batch 18 x 1024, flash attention,
# selective remat, loss_chunk 6144, default_optimizer(1e-4) (AdamW after a
# global-norm clip). Nothing cut.
SEL_PRESET = "gpt-410m"
SEL_BATCH, SEL_SEQ = 18, 1024
SEL_OVERRIDES = dict(attn_impl="flash", remat=True,
                     remat_policy="selective", loss_chunk=6144)
SEL_WARMUP, SEL_STEPS = 2, 4
# Step-0 loss of random logits, as LOSS0: a logit of the N(0, 0.02^2) head
# over a unit-variance hidden has std 0.02 * sqrt(1024) = 0.64, so the
# cross-entropy of a random target is ln(50304) + 0.64^2 / 2 = 11.03.
SEL_LOSS0, SEL_LOSS0_TOL = 11.03, 0.3
# The first gradients' global norm, selective against full remat from one
# state: the same forward, and a backward that reads kept values where the
# other recomputes them; the products and sums are the same, so they are
# expected equal, and 1e-5 (MESH_LOSS_RTOL's fp32 summation order) bounds
# a change in the order of a sum. A lost or doubled gradient moves it by
# O(1).
SEL_GRAD_RTOL = 1e-5
# The lookup phase: the embedding tables of bert-base (30522 x 768) and
# gpt-410m (50304 x 1024).
LOOKUP_TABLES = (("bert-base", 30522, 768), ("gpt-410m", 50304, 1024))
# gpt-moe-8x410m (ray_tpu/models/gpt.py: 24 layers, d_model 1024, 16 heads
# of 64, d_ff 4096, 8 experts, top-2, capacity factor 1.25, vocab 50304):
# K1-K3 at head dim 64. Served as gpt-1.3b is (4d) and trained with
# gpt-1.3b's recipe (5f).
MOE_PRESET = "gpt-moe-8x410m"
MOE_HEADS, MOE_HEAD_DIM = 16, 64
# Step-0 loss: a logit of the N(0, 0.02^2) head over a unit-variance hidden
# has std 0.02 * sqrt(1024) = 0.64, so the cross-entropy of a random target
# is ln(50304) + 0.64^2 / 2 = 11.03; the aux term adds 0.01 x 24 layers x
# about 1 (E * sum f p is 1 at perfect balance).
MOE_LOSS0, MOE_LOSS0_TOL = 11.27, 0.3
# 4d: gpt-moe-8x410m logits, flash against dot attention in bf16. Each
# run routing itself, a token whose top-2 experts differ between the runs
# (a rounding of the router's near-ties) takes another expert's output in
# that layer, which moves its residual by ~10% and its later routing and
# the keys and values other tokens attend to; and one flip moves which
# later tokens of its row an expert drops at capacity. So flips cascade
# with depth, and a flipped token's logits are another function's: their
# gap is of the order of the logits themselves, and is printed, not held.
# The held comparison replays the flash run's routes (experts, kept
# assignments, slots) in the dot and fp32 runs, which then differ by their
# arithmetic alone, as a dense model's do: gpt-1.3b's bound, over the
# whole buffer.
NUM_SLOTS, SEQ = 4, 1024
N_REQUESTS, MAX_NEW = 8, 16
ARRIVAL_STEPS = 2
PROMPT_LENS = (32, 512)
# Phase 4e: the diffusion UNet served through the port's @serve.batch, as
# examples/serve_diffusion.py deploys it: (preset, concurrent requests =
# max_batch_size). ddpm-cifar at bench.py's program (bench_diffusion: batch
# 64, 50 DDIM steps, eta 0); sd-base, the SD-shaped latent UNet of the
# example, at batch 8.
DIFF_SERVE = (("ddpm-cifar", 64), ("sd-base", 8))
DIFF_STEPS = 50
# The bf16 images against the same sampler in fp32 from the same x_T. x0 is
# clipped to [-3, 3], so pixels reach |3|, where a bf16 ulp is 2^-6; the
# gap is bf16 rounding carried through 50 steps, and on the CPU at batch
# 1-2 (tests/measure_unet_bf16_gap.py) it was of the same size in both
# packages, about 1.5 ulps at the top of the range. 2^-4 is 4 ulps there; a
# wrong timestep, schedule or cast moves pixels by O(0.1-1).
DIFF_BF16_TOL = 2.0 ** -4
# unet-tiny in fp32, 10 DDIM steps on the card against the CPU from one
# x_T: fp32 sums in different orders, carried through 10 steps (the images
# reach |3|); the CPU parity test holds the port to JAX at 1e-5.
UNET_TINY_TOL = 1e-4
# Phase 5h: training each of the zoo's models at full width with AdamW at
# weight decay 0 (optax.adam's arithmetic), lr 1e-4, 2 warm-up and 4 timed
# steps; the batches are random, drawn on the card from a seeded generator.
ZOO_WARMUP, ZOO_STEPS, ZOO_LR = 2, 4, 1e-4
# Phases 5i and 5k run the same models on the 1-rank mesh for fewer steps
# (cut from 5h's 2 + 4): their checks read the first steps (each loss
# against 5h's or 5i's same step, the first update), 2 timed steps give
# their ms per step beside 5h's.
ZOO_MESH_WARMUP, ZOO_MESH_STEPS = 1, 2
# Batches: DDPM's CIFAR-10 batch; ViT-B/16's 224x224 images; BERT's 512
# tokens, 15% masked; T5's 512 encoder and 128 decoder tokens.
ZOO_BATCH = {"ddpm-cifar": 128, "vit-b16": 64, "bert-base": 32,
             "t5-base": 16}
# Step-0 losses of the random initialisations, each with its bound:
# - ddpm-cifar: conv_out is drawn at 1e-2 of its fan-in scale, so the
#   predicted noise is ~0.03 and the MSE is E[eps^2] = 1 (the mean over
#   128 x 3072 draws of eps^2 has std 0.002);
# - vit-b16: after the final LayerNorm each unit has variance 1, so a logit
#   of the N(0, 0.02^2) head has std 0.02 sqrt(768) = 0.554 and the
#   cross-entropy of a random label is ln(1000) + 0.554^2 / 2 = 7.061; the
#   target logit's mean over 64 labels has std 0.07;
# - bert-base: the MLM transform ends in a LayerNorm and the tied wte is
#   N(0, 0.02^2), so as vit-b16's: ln(30522) + 0.554^2 / 2 = 10.480, over
#   ~2460 masked positions;
# - t5-base: the head is rmsnorm(x) d^-0.5 . wte with wte N(0, 1/d), so a
#   logit has std d^-0.5 = 0.036 and the loss is ln(32128) + 1/(2d) =
#   10.378.
ZOO_LOSS0 = {"ddpm-cifar": (1.0, 0.02), "vit-b16": (7.061, 0.35),
             "bert-base": (10.480, 0.2), "t5-base": (10.378, 0.05)}
# vit-tiny, bert-tiny and t5-tiny in fp32 on the card against the CPU: the
# logits to the CPU parity tests' bound (summation order), the first
# gradients as each tensor's difference over its norm, or over
# ZOO_GRAD_FLOOR of the largest tensor's where its own is smaller: BERT's
# bk has a zero gradient but for rounding (softmax ignores a shift that
# every key shares), so its own norm is noise.
ZOO_TINY_TOL = 1e-4
ZOO_GRAD_FLOOR = 1e-3
# Phase 5i: 5h's models on the 1-rank mesh. ViT and BERT chain their
# layers, and their steps are 5h's bit for bit. The UNet and T5 feed one
# tensor to several of FSDP2's units (the skips; the encoder's output), and
# FSDP2 passes each unit's inputs through an autograd node of its own: the
# gradient of such a tensor is summed in another association, in the
# activations' bf16, so the first gradients upstream of it differ by up to
# 1.4e-3 (UNet) and 1.2e-2 (T5) of their norm on this card
# (tests/measure_zoo_mesh_gap.py). There the step-0 loss is 5h's bit for
# bit; after the first AdamW step (lr g / (|g| + eps), about lr sign(g))
# every parameter is within 2 lr of 5h's; and a later loss within
# ZOO_MESH_LOSS_RTOL of 5h's: the gradients' bf16 gap (2^-8 of a term of
# the sums, 1e-2 measured) times the loss's relative change a step (2e-3
# for T5, 1.5e-2 for the UNet), over 5 steps.
ZOO_MESH_LOSS_RTOL = 1e-4
ZOO_MESH_EXACT = ("vit-b16", "bert-base")
# Phase 4f: gpt-1.3b through a deployment replica in a worker process on a
# share of the card (two shares fit, so a redeploy's new replica starts
# before the old one drains), fed phase 4's prompts.
DEPLOY_GPUS = 0.5
# Free card memory after serve.delete against before 4f: the replica
# processes' contexts and models go with them; what stays is this
# process's allocator and CUDA's own bookkeeping.
DEPLOY_FREE_SLACK = 1 << 30
# Phase 4g: the ported examples/serve_diffusion.py, its own defaults (10
# DDIM steps, batches of up to 8, its replica in this process).
EXAMPLE_PRESET, EXAMPLE_REQUESTS = "ddpm-cifar", 8
# This process's allocated card memory after the example's runtime is shut
# down against before: the replica's UNet must be gone; the allocator's
# rounding stays.
EXAMPLE_ALLOC_SLACK = 64 << 20
# The card's name and power limit, as nvidia-smi gives them (phase 1).
CARD = "not read"
# The range around the profiled run whose kernels _profile counts.
COUNTED_RUN = "chip_smoke: counted run"


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
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
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
    # (f, g) gpt-moe-8x410m's serving and training shapes: 16 heads of 64;
    # (h) the fp32 kernel at head dim 64 and S 1024.
    q, k, v, err, _ = _check_kernel(torch, fa, NUM_SLOTS, SEQ, MOE_HEADS,
                                    MOE_HEADS, MOE_HEAD_DIM, torch.bfloat16,
                                    True, 512, 8)
    row["gpt_moe_8x410m"] = {"max_abs_err": err,
                             **_k1_times(torch, fa, q, k, v, dname)}
    q, k, v, _, _ = _check_kernel(torch, fa, TRAIN_BATCH, TRAIN_SEQ,
                                  MOE_HEADS, MOE_HEADS, MOE_HEAD_DIM,
                                  torch.bfloat16, True, 512, 9)
    row["gpt_moe_8x410m"]["training"] = _k1_times(torch, fa, q, k, v, dname)
    _check_kernel(torch, fa, 2, SEQ, MOE_HEADS, MOE_HEADS, MOE_HEAD_DIM,
                  torch.float32, True, 512, 10)
    # (i) gpt-410m's training shape (phase 5j): 18 x 1024, 16 heads of 64.
    q, k, v, err, _ = _check_kernel(torch, fa, SEL_BATCH, SEL_SEQ, MOE_HEADS,
                                    MOE_HEADS, MOE_HEAD_DIM, torch.bfloat16,
                                    True, 512, 13)
    row["gpt_410m"] = {"max_abs_err": err,
                       "training": _k1_times(torch, fa, q, k, v, dname)}
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
    # gpt-moe-8x410m's training shape (head dim 64), and the fp32 kernels
    # there.
    k2["gpt_moe_8x410m"], k3["gpt_moe_8x410m"] = _bwd_times(
        torch, fa, TRAIN_BATCH, TRAIN_SEQ, MOE_HEADS, MOE_HEADS,
        MOE_HEAD_DIM, 512, 11)
    _check_backward(torch, fa, 2, TRAIN_SEQ, MOE_HEADS, MOE_HEADS,
                    MOE_HEAD_DIM, torch.float32, True, 512, 12)
    # gpt-410m's training shape (phase 5j).
    k2["gpt_410m"], k3["gpt_410m"] = _bwd_times(
        torch, fa, SEL_BATCH, SEL_SEQ, MOE_HEADS, MOE_HEADS, MOE_HEAD_DIM,
        512, 14)
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
    """gpt-1.3b served; returns the K1 launches, the last step's buffer
    and the served run's prompts, tokens and rates (for 4f)."""
    from ray_tpu_torch.models import gpt
    launches, buf, _, served = _serve(
        torch, gpt, gpt.config(SERVE_PRESET, attn_impl="flash"),
        SERVE_PRESET, FLASH_VS_DOT_TOL)
    return launches, buf, served


def phase_moe_serving(torch):
    """gpt-moe-8x410m served as gpt-1.3b is: K1 at head dim 64 once per
    layer per step; the top-2 experts of every token in every layer
    recorded under flash and under dot attention, the logits held to
    gpt-1.3b's bound with the flash run's routes replayed, and the fp32
    run's first MoE layer held to its index version."""
    from ray_tpu_torch.models import gpt
    return _serve(torch, gpt, gpt.config(MOE_PRESET, attn_impl="flash"),
                  MOE_PRESET, FLASH_VS_DOT_TOL, routes=True)[0]


def phase_llama_serving(torch):
    """llama3-8b served as gpt-1.3b is: K1 on 32 query heads over 8 KV
    heads, once per layer per step."""
    from ray_tpu_torch.models import llama
    return _serve(torch, llama, llama.config(LLAMA_PRESET, attn_impl="flash"),
                  LLAMA_PRESET, LLAMA_FLASH_VS_DOT_TOL)[:3]


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


class _Routes:
    """Within it, every MoE layer's top-k experts of every token and the
    experts that kept a slot for it, in call order: ``models.gpt.
    _moe_route`` wrapped. With ``replay`` (the _Routes of another run of
    the same model and tokens) each layer takes that run's routing (its
    experts, kept assignments and slots) and only its own router
    probabilities for the gates, so the runs differ by their arithmetic
    alone."""

    def __init__(self, gpt, replay=None):
        self.gpt, self.replay = gpt, replay
        self.top, self.kept, self.routing = [], [], []
        self.first_input = None  # the first MoE layer's h

    def __enter__(self):
        route = self._route = self.gpt._moe_route

        def recording(cfg, h, block):
            if not self.top:
                self.first_input = h
            out = route(cfg, h, block)
            if self.replay is not None:
                layer = self.replay.routing[len(self.top)]
                out = (out[0],) + layer + out[5:]
            else:
                self.routing.append(out[1:5])
            self.top.append(out[1].sort(-1).values)  # [B, S, K]
            self.kept.append(out[3].sum(2) > 0)  # [B, S, E]
            return out
        self.gpt._moe_route = recording
        return self

    def __exit__(self, *exc):
        self.gpt._moe_route = self._route


def _route_flips(torch, a, b, real):
    """(the share of the ``real`` [B, S] tokens whose top-k sets differ
    between two runs' routes, per layer; a [B, S] mask of the tokens whose
    top-k experts and kept slots are alike in every layer)."""
    differ = torch.stack([(x != y).any(-1) for x, y in zip(a.top, b.top)])
    dropped = torch.stack([(x != y).any(-1) for x, y in zip(a.kept,
                                                             b.kept)])
    share = (differ & real).float().sum((1, 2)) / real.sum()
    return share, ~(differ | dropped).any(0)


def _moe_layer_by_index(torch, cfg, h, block):
    """The MoE layer's semantics (``ray_tpu/models/gpt.py`` ``_moe_ffn``)
    computed by index, apart from the port's one-hot dispatch: ``torch.
    topk`` experts, each assignment's slot by a stable sort of its row's
    (sequence, k)-ordered experts, each expert's kept tokens gathered, run
    and scattered back. → (out, aux, top-k experts [B, S, K], kept [B, S,
    K])."""
    import torch.nn.functional as F
    B, S, d = h.shape
    E = cfg.n_experts
    K = min(cfg.expert_top_k, E)
    C = max(1, int(cfg.capacity_factor * S * K / E))
    probs = torch.softmax(h.float() @ block.router.float(), dim=-1)
    gates, top = torch.topk(probs, K, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    flat = top.reshape(B, S * K)
    order = torch.sort(flat, dim=1, stable=True).indices
    ranked = flat.gather(1, order)
    first = torch.searchsorted(
        ranked, torch.arange(E, device=h.device).expand(B, E).contiguous())
    slot = torch.empty_like(flat)
    slot.scatter_(1, order, torch.arange(S * K, device=h.device)
                  - first.gather(1, ranked))
    kept = (slot < C).reshape(B, S, K)
    out = torch.zeros_like(h)
    for e in range(E):
        b, t, k = ((top == e) & kept).nonzero(as_tuple=True)
        y = F.gelu(h[b, t] @ block.w_in[e] + block.b_in[e],
                   approximate="tanh") @ block.w_out[e]
        out.index_put_((b, t), y * gates[b, t, k, None], accumulate=True)
    f = F.one_hot(top[..., 0], E).float().mean((0, 1))
    aux = E * torch.sum(f * probs.mean((0, 1)))
    return out, aux, top, kept


def _check_moe_routing(torch, gpt, cfg, h, block, routing):
    """The port's MoE layer on ``h`` (fp32, the fp32 run's first layer
    input) and the routing that run recorded, against
    :func:`_moe_layer_by_index`: the top-k experts and kept assignments
    exactly, the output and aux term to MICRO_TOL."""
    with torch.inference_mode():
        out, aux = gpt._moe_ffn(cfg, h, block)
        want, want_aux, top, kept = _moe_layer_by_index(torch, cfg, h, block)
    C = max(1, int(cfg.capacity_factor * h.shape[1]
                   * min(cfg.expert_top_k, cfg.n_experts) / cfg.n_experts))
    gate_idx, keep = routing[0], routing[2].sum(-1) > 0
    differ = int((gate_idx != top).any(-1).sum())
    kept_differ = int((keep != kept).sum())
    err = float((out - want).abs().max())
    aux_err = abs(float(aux / want_aux) - 1)
    print(f"serve: {MOE_PRESET}: the fp32 run's first MoE layer "
          f"({tuple(h.shape)}, {cfg.n_experts} experts, capacity {C}) "
          f"against the layer by index: tokens whose top-2 differ "
          f"{differ}, kept assignments that differ {kept_differ} of "
          f"{kept.numel()} ({int((~kept).sum())} dropped by the index "
          f"version); max|dout| {err:.3e} (max|out| "
          f"{float(want.abs().max()):.3e}, bound {MICRO_TOL:.0e} + rel), "
          f"aux {float(aux):.6f} (rel diff {aux_err:.3e}, bound "
          f"{MICRO_TOL:.0e})")
    check(differ == 0 and kept_differ == 0,
          "the MoE layer routes otherwise than its index version")
    check(bool(((out - want).abs() <= MICRO_TOL + MICRO_TOL * want.abs())
               .all()) and aux_err <= MICRO_TOL,
          "the MoE layer disagrees with its index version")


def _serve(torch, module, cfg, preset, flash_vs_dot_tol, routes=False):
    """8 requests through the port's ContinuousBatcher over ``module``'s
    model at ``cfg`` (random weights from a seeded generator, flash
    attention); then the last step's logits under flash and dot attention,
    and a profile of one step. With ``routes`` (a MoE model) the share of
    the buffer's tokens (each slot's first ``lens``) whose top-2 experts
    differ between the runs, each routing itself, and those runs' gaps are
    printed; the dot and fp32 logits held to the bound are then those of
    runs that replay the flash run's routes (the note on 4d above
    ``NUM_SLOTS`` says why). Frees the model and
    returns the K1 launches of the served run, the last step's buffer,
    its flash logits and the served run's prompts, tokens and rates."""
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
    served = {"prompts": prompts, "tokens": outs, "steps": steps,
              "ms_step": wall / steps * 1e3,
              "tokens_s": N_REQUESTS * MAX_NEW / wall}

    # The last step's buffer under flash and under dot attention, and under
    # dot attention in fp32 (parameters are fp32; TF32 is off).
    # A MoE model also runs dot and fp32 with the flash run's routes.
    from ray_tpu_torch.models import gpt

    def logits(run_cfg, replay=None):
        model.cfg = run_cfg
        with torch.inference_mode(), _Routes(gpt, replay) as run:
            out = model(state["buf"])
        model.cfg = cfg
        return out, run
    flash_raw, flash_routes = logits(cfg)
    flash = flash_raw.float()
    dot, dot_routes = logits(replace(cfg, attn_impl="dot"))
    fp32, fp32_routes = logits(replace(cfg, attn_impl="dot",
                                       dtype=torch.float32))
    dot = dot.float()
    check(flash.shape == (NUM_SLOTS, SEQ, cfg.vocab_size),
          f"logits shape {tuple(flash.shape)}")
    check(bool(torch.isfinite(flash).all()), "non-finite logits")
    def gap_at(a, b, mask=None):
        d = (a - b).abs().amax(-1)
        return float(d.max() if mask is None else (d * mask).max())
    free = ""
    if routes:
        check(len(flash_routes.top) == cfg.n_layers,
              f"{len(flash_routes.top)} MoE layers ran, not {cfg.n_layers}")
        real = (torch.arange(SEQ, device=DEVICE)[None, :]
                < torch.tensor(state["lens"], device=DEVICE)[:, None])
        flips, alike = _route_flips(torch, flash_routes, dot_routes, real)
        flips32, alike32 = _route_flips(torch, flash_routes, fp32_routes,
                                        real)
        print(f"serve: {preset}: each run routing itself: of the "
              f"buffer's {int(real.sum())} tokens, those whose top-2 "
              f"experts differ, flash against dot: "
              f"{float(flips.mean()):.4%} of (layer, token) pairs, per "
              f"layer {[round(float(f), 5) for f in flips]}, "
              f"{float((real & ~alike).sum() / real.sum()):.4%} of tokens "
              f"routed or kept otherwise in some layer; flash against "
              f"fp32: {float(flips32.mean()):.4%} and "
              f"{float((real & ~alike32).sum() / real.sum()):.4%}; "
              f"max|dlogit| flash vs dot {gap_at(flash, dot, real):.4f} "
              f"over the buffer's tokens, "
              f"{gap_at(flash, dot, alike & real):.4f} over the "
              f"{int((alike & real).sum())} routed and kept "
              f"alike in every layer, {gap_at(flash, dot, ~real):.4f} over "
              f"the padding; flash vs fp32 {gap_at(flash, fp32, real):.4f} "
              f"over the buffer's tokens (not held)")
        free = (f" (each routing itself: {gap_at(flash, dot):.4f}, "
                f"{gap_at(flash, fp32):.4f}, {gap_at(dot, fp32):.4f})")
        _check_moe_routing(torch, gpt, replace(cfg, attn_impl="dot",
                                               dtype=torch.float32),
                           fp32_routes.first_input, model.blocks[0],
                           fp32_routes.routing[0])
        dot, _ = logits(replace(cfg, attn_impl="dot"), flash_routes)
        fp32, _ = logits(replace(cfg, attn_impl="dot", dtype=torch.float32),
                         flash_routes)
        dot = dot.float()
    gap, gap32, dot32 = (gap_at(a, b) for a, b in (
        (flash, dot), (flash, fp32), (dot, fp32)))
    where = ("with the flash run's routes, over the whole buffer" if routes
             else "over the whole buffer")
    print(f"serve: {preset}: max|logit| {float(flash.abs().max()):.4f}; "
          f"{where}: flash vs dot max|dlogit| {gap:.4f} (bound "
          f"{flash_vs_dot_tol}); against the fp32 forward: flash "
          f"{gap32:.4f} (same bound), dot {dot32:.4f}{free}")
    check(gap <= flash_vs_dot_tol, "flash and dot logits disagree")
    check(gap32 <= flash_vs_dot_tol,
          "flash logits disagree with the fp32 forward")
    del flash, dot, fp32, flash_routes, dot_routes, fp32_routes
    _profile_step(torch, model, state["buf"])
    buf = state["buf"].clone()
    # The engine's parked decode task and the engine refer to each other:
    # collect the cycle, so the model's memory is free for later phases.
    del model, state, engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches, buf, flash_raw, served


def _profile_step(torch, model, buf):
    """Device time of one serving step's forward, by kernel (a profiler
    window after the counted run; the launches here are not counted)."""
    def forward():
        with torch.inference_mode():
            model(buf)
    forward()  # warm
    torch.cuda.synchronize()
    _profile(torch, forward, f"one forward of [{NUM_SLOTS}, {SEQ}]", 8)


def _profile(torch, fn, what, top, expect=(), ranges=(), convs=False,
             stats=None):
    """Run fn once under torch.profiler and print its device time by
    kernel, the top ``top`` kernels by device time, the port's flash
    kernels by name, and the step's time on the host clock; returns the
    device time in ms (None when the profiler saw none). Each name in
    ``expect`` must be among the kernels the profiler saw. For each of
    the ``record_function`` ``ranges``, the device time of the kernels
    launched inside it (forward and remat's replay; the backward's
    kernels run outside it). With ``convs``, cuDNN's convolution kernels
    are a class of their own, counted before the GEMMs. A ``stats`` dict
    gets under "kernels" the count of kernels one run of fn launched
    (copies, fills and annotations are no kernels): fn then runs twice
    under the profiler and only the second run is read
    (:func:`_counted_run`), so what the profiler drops as its trace
    starts falls in the first. A count, not a gate: the profiler may also
    lose a kernel's record later in a run (:func:`_dispatched` is
    exact)."""
    from contextlib import nullcontext

    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if stats is not None:
            fn()
            torch.cuda.synchronize()
        with (nullcontext() if stats is None
              else record_function(COUNTED_RUN)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    # key_averages() parses every event in Python (tens of seconds for a
    # t5-base step's): the counted run reads the raw events instead, and
    # the averages are parsed only where they are read.
    averages = (prof.key_averages() if stats is None or ranges else None)
    if stats is None:
        # The ranges also appear on the device's timeline, as annotations.
        events = [e for e in averages
                  if getattr(e, "device_type", None) is not None
                  and str(e.device_type).endswith("CUDA")
                  and e.key not in ranges]
    else:
        events = _counted_run(prof)
        stats["kernels"] = sum(
            e.count for e in events
            if not e.key.startswith(("Memcpy", "Memset"))) or None
    total = sum(e.self_device_time_total for e in events)
    if not total:
        print("profile: the profiler saw no device time (not measured)")
        return None
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
    if convs:
        classes = {"convolutions (cuDNN)": (
            "fprop", "dgrad", "wgrad", "cudnn", "implicit_gemm", "winograd",
            "convolve", "nchwtonhwc", "nhwctonchw"), **classes}
    rest, seen = total, set()
    for label, keys in classes.items():
        mine = [e for e in events if e.key not in seen
                and any(k in (e.key.lower() if label.startswith("conv")
                              else e.key) for k in keys)]
        seen.update(e.key for e in mine)
        t = sum(e.self_device_time_total for e in mine)
        rest -= t
        print(f"  by class: {label} {t / 1e3:.3f} ms ({t / total:.1%})")
    print(f"  by class: everything else {rest / 1e3:.3f} ms "
          f"({rest / total:.1%})")
    for name in ranges:
        mine = [e for e in averages if e.key == name
                and not str(e.device_type).endswith("CUDA")]
        t = sum(e.device_time_total for e in mine)
        n = sum(e.count for e in mine)
        print(f"  range {name}: {t / 1e3:.3f} ms ({t / total:.1%}) of "
              f"device time inside it, x{n}")
    return total / 1e3


def _counted_run(prof):
    """The device events of the run inside ``COUNTED_RUN``, annotations
    left out, by name (``key``, ``count``, ``self_device_time_total`` in
    us, as ``key_averages()`` rows). An event belongs to the run when the
    host event that launched it (the one its correlation id links it to,
    on any thread: the backward's too) starts inside the range; both
    times are the host's clock. The run before ends with a
    synchronisation, so none of its kernels is counted here, whatever
    the profiler lost of it."""
    from torch.autograd import DeviceType
    raw = prof.profiler.kineto_results.events()
    span = next(e for e in raw if e.name() == COUNTED_RUN
                and e.device_type() == DeviceType.CPU)
    lo, hi = span.start_ns(), span.start_ns() + span.duration_ns()
    launched = {e.correlation_id() for e in raw
                if e.device_type() == DeviceType.CPU
                and e.linked_correlation_id() == 0
                and lo <= e.start_ns() <= hi}
    rows = {}
    for e in raw:
        if (e.device_type() == DeviceType.CUDA
                and not e.is_user_annotation()
                and e.linked_correlation_id() in launched):
            n, us = rows.get(e.name(), (0, 0.0))
            rows[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return [types.SimpleNamespace(key=k, count=n, self_device_time_total=us)
            for k, (n, us) in rows.items()]


def _dispatched(torch, fn):
    """The operators one run of fn dispatches (a ``TorchDispatchMode``,
    which the backward's thread inherits), counted by name and the shapes
    of their tensor arguments: every kernel of the run is launched by one
    of them. Exact, where a profile is not: the profiler may lose a
    kernel's record (PERF.md §6, PR 13)."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            shapes = tuple(tuple(a.shape) for a in tree_leaves((args, kwargs))
                           if isinstance(a, torch.Tensor))
            self.ops[f"{func} {shapes}"] += 1
            return func(*args, **kwargs)
    with Count() as mode:
        fn()
        torch.cuda.synchronize()
    return mode.ops


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


def phase_moe_small(torch):
    """gpt-moe-tiny in fp32 (4 experts, top-2; head dim 16) through the
    kernels on the card against the plain versions on the CPU, from the
    same weights and tokens: logits, the aux term, and the first
    gradients."""
    from ray_tpu_torch.models import gpt
    cfg = gpt.config("gpt-moe-tiny", attn_impl="flash")
    cpu = gpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = gpt.GPT(cfg, device=DEVICE)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, cfg.max_seq_len + 1)))
    tokens, targets = toks[:, :-1], toks[:, 1:]
    with torch.inference_mode():
        ref, ref_aux = cpu.forward_with_aux(tokens)
        got, got_aux = card.forward_with_aux(tokens.to(DEVICE))
    got, got_aux = got.cpu(), got_aux.cpu()
    err = float((got - ref).abs().max())
    aux_err = abs(float(got_aux / ref_aux) - 1)
    grads = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, DEVICE)):
        loss, _ = gpt.loss_fn(model, tokens.to(dev), targets.to(dev))
        grads[name] = [g.cpu() for g in torch.autograd.grad(
            loss, list(model.parameters()))]
    grad_err = max(float((a - b).norm() / b.norm())
                   for a, b in zip(grads["card"], grads["cpu"]))
    print(f"gpt-moe-tiny fp32, card kernels vs CPU plain versions: "
          f"max|dlogit| {err:.3e} (bound {MICRO_TOL:.0e}), aux "
          f"{float(got_aux):.6f} (rel diff {aux_err:.3e}, bound "
          f"{MICRO_TOL:.0e}); max over tensors of |dgrad| / |grad| "
          f"{grad_err:.3e} (bound {MICRO_GRAD_RTOL:.0e})")
    check(bool(((got - ref).abs() <= MICRO_TOL + MICRO_TOL * ref.abs())
               .all()) and aux_err <= MICRO_TOL,
          "gpt-moe-tiny on the card disagrees with the CPU")
    check(grad_err <= MICRO_GRAD_RTOL,
          "gpt-moe-tiny gradients on the card disagree with the CPU")


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
                    "losses": losses, "fingerprints": prints,
                    "step_ms": [t * 1e3 for t in step_s]}


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


def phase_lookups(torch):
    """The lookups on the card as the JAX package's ``jnp.take`` and
    ``jnp.take_along_axis`` take them, at bert-base's and gpt-410m's
    tables: ids and targets -1, V and -V-1 (and 0, V-1) read the wrapped
    row or logit bit for bit, NaN out of range, the embedding's gradient
    only on the rows the ids in range read; every index is clamped before
    a gather, so no device-side assert fires (which would end the CUDA
    context: the synchronize surfaces one)."""
    from ray_tpu_torch.models import _common, bert

    for name, V, d in LOOKUP_TABLES:
        g = torch.Generator(DEVICE).manual_seed(7)
        table = torch.randn((V, d), generator=g, device=DEVICE,
                            requires_grad=True)
        ids = torch.tensor([[-1, V, -V - 1, 0, V - 1]], device=DEVICE)
        rows = _common.embed(ids, table)
        ct = torch.randn(rows.shape, generator=g, device=DEVICE)
        rows.backward(ct)
        segs = bert._segment_rows(torch.tensor([[-1, 2, -3, 0, 1]],
                                               device=DEVICE), table[:2])
        logits = torch.randn((5, V), generator=g, device=DEVICE,
                             requires_grad=True)
        nll = torch.stack([_common.ce_stats(
            logits[i:i + 1], ids[0, i:i + 1],
            torch.ones(1, device=DEVICE))[0] for i in range(5)])
        hits = _common.ce_stats(logits, ids[0], torch.ones(5, device=DEVICE))
        nll.sum().backward()
        torch.cuda.synchronize()
        t = table.detach()
        check(torch.equal(rows[0, [0, 3, 4]], t[[V - 1, 0, V - 1]])
              and bool(torch.isnan(rows[0, 1:3]).all()),
              f"{name}: embed of ids -1, V, -V-1, 0, V-1")
        want = torch.zeros_like(t)
        want[V - 1] = ct[0, 0] + ct[0, 4]
        want[0] = ct[0, 3]
        check(torch.equal(table.grad, want),
              f"{name}: the embedding's gradient is not on the wrapped "
              f"rows alone")
        check(torch.equal(segs[0, [0, 3, 4]], t[[1, 0, 1]])
              and bool(torch.isnan(segs[0, 1:3]).all()),
              f"{name}: segment rows of ids -1, 2, -3, 0, 1")
        lg = logits.detach()
        want_nll = torch.stack([
            torch.logsumexp(lg[i:i + 1], -1)[0] - lg[i, t]
            for i, t in ((0, V - 1), (3, 0), (4, V - 1))])
        check(torch.equal(nll.detach()[[0, 3, 4]], want_nll)
              and bool(torch.isnan(nll[1:3]).all()),
              f"{name}: nll of targets -1, V, -V-1, 0, V-1")
        # Rows 1-2 (targets out of range): logz's gradient alone, the
        # softmax; a target added to a clamped logit would move one by 1.
        check(bool(torch.isfinite(logits.grad).all())
              and torch.allclose(logits.grad[1:3],
                                 torch.softmax(lg[1:3], -1), rtol=1e-5,
                                 atol=1e-12),
              f"{name}: an out-of-range target added to a logit")
        n_hits = int(float(hits[1]))
        want_hits = int(lg.argmax(-1)[3] == 0) + int(lg.argmax(-1)[4]
                                                      == V - 1)
        check(n_hits == want_hits,
              f"{name}: hits {n_hits}, expected {want_hits} (-1 never hits)")
        print(f"lookups: {name} ({V} x {d}): ids -1, V, -V-1 read row V-1, "
              f"NaN, NaN bit for bit; gradient on rows 0 and V-1 only; "
              f"targets: nll of -1 is logz - logit[V-1], NaN for V and "
              f"-V-1, no gradient into their logits beyond logz's; no "
              f"device-side assert")
        del table, logits, rows, nll, ct
    torch.cuda.empty_cache()


def _sel_run(torch, name, cfg, mesh, rules, batch):
    """SEL_WARMUP + SEL_STEPS steps of gpt-410m's recipe from seed 0 →
    (losses, step seconds, (K1, K2, K3) launches per step, their totals,
    peak memory above what was held before the state, the state's GiB)."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import train_step as ts

    base = torch.cuda.memory_allocated()
    opt = ts.default_optimizer(learning_rate=1e-4)
    state = ts.init_train_state(cfg, mesh, rules, opt, seed=0,
                                device=DEVICE)
    step = ts.make_train_step(cfg, mesh, rules, opt)
    torch.cuda.synchronize()
    state_gib = (torch.cuda.memory_allocated() - base) / 2**30
    if mesh is not None:
        _check_placed(state["params"], name)
    losses, step_s, per_step = [], [], []
    _zero_counts(fa)
    for i in range(SEL_WARMUP + SEL_STEPS):
        if i == SEL_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        counts0 = _counts(fa)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(tuple(b - a for a, b in zip(counts0, _counts(fa))))
        losses.append(float(metrics["loss"]))
    counts = _counts(fa)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    del state, step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return losses, step_s, per_step, counts, peak, state_gib


def phase_selective_training(torch, mesh):
    """gpt-410m's recipe (selective remat) through the port's train step:
    the first gradients of both policies from one state; then full remat,
    selective remat, and selective remat on prepare_mesh's 1-rank mesh
    under the all-None rules and under tp_fsdp_rules(), 2 warm-up and 4
    timed steps each from seed 0. Returns the (K1, K2, K3) launches."""
    from dataclasses import replace

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import tp_fsdp_rules

    cfg = gpt.config(SEL_PRESET, **SEL_OVERRIDES)
    batch = _train_batch(torch, cfg, SEL_BATCH, SEL_SEQ, 0, DEVICE)
    L = cfg.n_layers
    print(f"selective: {SEL_PRESET} ({cfg.num_params() / 1e9:.3f} B params, "
          f"{L} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}), batch {SEL_BATCH} x {SEL_SEQ}, {SEL_OVERRIDES},"
          f" default_optimizer(1e-4)")

    # The first gradients of each policy from one state (init_train_state's
    # weights for seed 0).
    model = gpt.init(cfg, torch.Generator(DEVICE).manual_seed(0), DEVICE)
    params = list(model.parameters())
    first = {}
    for policy in ("full", "selective"):
        model.cfg = replace(cfg, remat_policy=policy)
        loss, _ = gpt.loss_fn(model, batch["tokens"], batch["targets"])
        grads = torch.autograd.grad(loss, params)
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        first[policy] = (float(loss.detach()), float(norm))
        del loss, grads
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    (loss_f, norm_f), (loss_s, norm_s) = first["full"], first["selective"]
    check(loss_s == loss_f, f"step-0 loss: selective {loss_s!r}, full "
          f"{loss_f!r} (the same forward)")
    check(abs(norm_s / norm_f - 1) <= SEL_GRAD_RTOL,
          f"first gradients' norm: selective {norm_s!r}, full {norm_f!r}")
    check(abs(loss_s - SEL_LOSS0) <= SEL_LOSS0_TOL,
          f"step-0 loss {loss_s} is not within {SEL_LOSS0_TOL} of "
          f"{SEL_LOSS0}")
    print(f"selective: from one state, step-0 loss {loss_s!r} under both "
          f"policies; first gradients' norm selective {norm_s!r}, full "
          f"{norm_f!r} (rel {abs(norm_s / norm_f - 1):.3e}, bound "
          f"{SEL_GRAD_RTOL:.0e})")

    runs = [("full remat", replace(cfg, remat_policy="full"), None, None,
             (2 * L, L, L)),
            ("selective", cfg, None, None, (L, L, L)),
            ("selective, mesh, rules all None (bench.py)", cfg, mesh,
             _all_rules(), (L, L, L)),
            ("selective, mesh, tp_fsdp_rules()", cfg, mesh, tp_fsdp_rules(),
             (L, L, L))]
    total, out = [0, 0, 0], {}
    for name, run_cfg, run_mesh, rules, per_layer in runs:
        losses, step_s, per_step, counts, peak, state_gib = _sel_run(
            torch, name, run_cfg, run_mesh, rules, batch)
        total = [t + c for t, c in zip(total, counts)]
        check(all(c == per_layer for c in per_step),
              f"{name}: launches per step (K1, K2, K3) {per_step}, "
              f"expected {per_layer}")
        check(np.isfinite(losses).all(), f"{name}: losses {losses}")
        timed = step_s[SEL_WARMUP:]
        mean_s = statistics.mean(timed)
        tokens_s = SEL_BATCH * SEL_SEQ / mean_s
        mfu = tokens_s * gpt.flops_per_token(cfg) / PEAK_FLOPS["bfloat16"]
        out[name] = (losses, mean_s, peak)
        print(f"selective: {name}: losses {losses}; {SEL_STEPS} timed steps "
              f"{[round(t * 1e3, 2) for t in timed]} ms, mean "
              f"{mean_s * 1e3:.2f} ms/step (std "
              f"{statistics.pstdev(timed) * 1e3:.2f}), {tokens_s:.1f} "
              f"tokens/s, MFU {mfu:.2%} of the 989 TFLOP/s bf16 peak; peak "
              f"memory {peak:.2f} GiB above what was held before the state "
              f"({state_gib:.2f} GiB of state); launches (K1, K2, K3) "
              f"{counts} = {per_layer} per step")
    full, sel = out["full remat"][0], out["selective"][0]
    check(sel[0] == full[0], f"step-0 loss: selective {sel[0]!r}, full "
          f"{full[0]!r}")
    for name, _, run_mesh, _, _ in runs[2:]:
        losses = out[name][0]
        rel = [abs(a / b - 1) for a, b in zip(losses, sel)]
        check(losses[0] == sel[0] and max(rel) <= MESH_LOSS_RTOL,
              f"{name}: losses {losses} against the selective step's "
              f"without a mesh {sel}")
        print(f"selective: {name}: step-0 loss bit-equal to the step "
              f"without a mesh, max rel dloss {max(rel):.3e} (bound "
              f"{MESH_LOSS_RTOL:.0e}); ms/step {out[name][1] * 1e3:.2f} "
              f"(without a mesh {out['selective'][1] * 1e3:.2f}, full remat "
              f"{out['full remat'][1] * 1e3:.2f})")
    return tuple(total)


# -- 5f, 5g. gpt-moe-8x410m ---------------------------------------------------

def _moe_steps(torch, cfg, state, step, batch, n_steps, warmup):
    """``n_steps`` of ``step``: (losses, seconds per step, (K1, K2, K3)
    launches per step, each step's fingerprint of the parameters' local
    blocks, peak memory over the steps after ``warmup``)."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.sharding import local
    losses, step_s, per_step, prints = [], [], [], []
    for i in range(n_steps):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()
        counts0 = _counts(fa)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(tuple(b - a for a, b in zip(counts0, _counts(fa))))
        losses.append(float(metrics["loss"]))
        prints.append(_fingerprint(torch, {
            n: local(p) for n, p in state["params"].named_parameters()}))
    return (state, losses, step_s, per_step, prints,
            torch.cuda.max_memory_allocated())


def phase_moe_training(torch):
    """gpt-moe-8x410m at full width and depth with gpt-1.3b's recipe
    (batch 12 x 1024, flash attention, full remat, loss_chunk 4096,
    Adafactor after the global-norm clip): 2 warm-up and 6 timed steps,
    each launching K1 48 times and K2 and K3 24 times at head dim 64; the
    step-0 loss, the first update (lr 0), ms per step, MFU by the active
    experts' FLOPs, peak memory, and a profile of one step with the MoE
    layer's ranges. Returns the launches and phase 5g's reference."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import train_step as ts

    cfg = gpt.config(MOE_PRESET, **TRAIN_OVERRIDES)
    opt = ts.memory_efficient_optimizer(learning_rate=1e-4)
    t0 = time.perf_counter()
    state = ts.init_train_state(cfg, optimizer=opt, seed=0, device=DEVICE)
    step = ts.make_train_step(cfg, optimizer=opt)
    batch = _train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, 0, DEVICE)
    before = _fingerprint(torch, dict(state["params"].named_parameters()))
    torch.cuda.synchronize()
    print(f"train: {MOE_PRESET} ({cfg.num_params() / 1e9:.3f} B params, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.head_dim}, {cfg.n_experts} experts top-"
          f"{cfg.expert_top_k}), batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{TRAIN_OVERRIDES}, Adafactor lr 1e-4; state initialised in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    _zero_counts(fa)
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    state, losses, step_s, per_step, prints, peak = _moe_steps(
        torch, cfg, state, step, batch, n_steps, TRAIN_WARMUP)
    counts = _counts(fa)
    per_layer = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    check(all(c == per_layer for c in per_step),
          f"launches per step (K1, K2, K3) {per_step}, expected {per_layer}")
    check(torch.equal(prints[0], before),
          "the first update changed a parameter")
    check(np.isfinite(losses).all()
          and abs(losses[0] - MOE_LOSS0) <= MOE_LOSS0_TOL,
          f"step-0 loss {losses[0]} is not within {MOE_LOSS0_TOL} of "
          f"{MOE_LOSS0}")
    timed = step_s[TRAIN_WARMUP:]
    mean_s = statistics.mean(timed)
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / mean_s
    mfu = tokens_s * gpt.flops_per_token(cfg) / PEAK_FLOPS["bfloat16"]
    print(f"train: {MOE_PRESET}: losses {[round(x, 5) for x in losses]}; "
          f"first update left every parameter's fp64 sum and norm unchanged")
    print(f"train: {MOE_PRESET}: {TRAIN_STEPS} timed steps: "
          f"{[round(t * 1e3, 2) for t in timed]} ms; mean {mean_s * 1e3:.2f}"
          f" ms/step (std {statistics.pstdev(timed) * 1e3:.2f}), "
          f"{tokens_s:.1f} tokens/s, model FLOPs "
          f"{gpt.flops_per_token(cfg):.4e}/token (active experts), MFU "
          f"{mfu:.2%} of the 989 TFLOP/s bf16 peak; peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"train: {MOE_PRESET}: launches over {n_steps} steps (K1, K2, K3) "
          f"{counts} = {per_layer} per step")
    _profile(torch, lambda: step(state, batch),
             f"one training step of {MOE_PRESET} (full remat)", 20,
             expect=WGMMA_KERNELS, ranges=("moe.route", "moe.dispatch",
                                           "moe.experts", "moe.combine"))
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"losses": losses, "fingerprints": prints,
                    "ms_per_step": mean_s * 1e3, "peak_gib": peak / 2**30}


def phase_moe_mesh(torch, mesh, ref, buf):
    """On the 1-rank mesh: 5f's recipe under tp_fsdp_rules() (the experts
    over an ep of one), each step's loss and parameters bit-equal to 5f's;
    then gpt-1.3b placed by context_parallel_rules() runs forward on phase
    4's last buffer under attn_impl "ring" and "ulysses" (the sequence
    over an sp of one), each within the bf16 bound of "dot" and launching
    no kernel. Returns the (K1, K2, K3) launches."""
    from dataclasses import replace

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import (context_parallel_rules,
                                        tp_fsdp_rules)
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.mesh import registered_mesh

    cfg = gpt.config(MOE_PRESET, **TRAIN_OVERRIDES)
    opt = ts.memory_efficient_optimizer(learning_rate=1e-4)
    state = ts.init_train_state(cfg, mesh, tp_fsdp_rules(), opt, seed=0,
                                device=DEVICE)
    step = ts.make_train_step(cfg, mesh, tp_fsdp_rules(), opt)
    batch = _train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, 0, DEVICE)
    model = state["params"]
    _check_placed(model, "tp_fsdp_rules()")
    w_in = dict(model.named_parameters())["blocks.0.w_in"]
    check(w_in.device_mesh.mesh_dim_names == ("dp", "fsdp", "tp", "ep"),
          f"blocks.0.w_in lies on {w_in.device_mesh.mesh_dim_names}")
    print(f"mesh: {MOE_PRESET}: blocks.0.w_in {tuple(w_in.shape)} on "
          f"{w_in.device_mesh.mesh_dim_names} as {w_in.placements}")
    _zero_counts(fa)
    n_steps = MESH_WARMUP + MESH_STEPS
    state, losses, step_s, per_step, prints, peak = _moe_steps(
        torch, cfg, state, step, batch, n_steps, MESH_WARMUP)
    counts = _counts(fa)
    per_layer = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    check(all(c == per_layer for c in per_step),
          f"launches per step (K1, K2, K3) {per_step}, expected {per_layer}")
    same = [a == b and torch.equal(p, q) for a, b, p, q in zip(
        losses, ref["losses"], prints, ref["fingerprints"])]
    print(f"mesh: {MOE_PRESET} under tp_fsdp_rules(): losses {losses}; "
          f"each step's loss and parameters' fp64 sums and norms bit-equal "
          f"to 5f's: {same}; {MESH_STEPS} timed steps "
          f"{[round(t * 1e3, 2) for t in step_s[MESH_WARMUP:]]} ms, mean "
          f"{statistics.mean(step_s[MESH_WARMUP:]) * 1e3:.2f} ms/step (5f: "
          f"{ref['ms_per_step']:.2f}), peak memory {peak / 2**30:.2f} GiB "
          f"(5f: {ref['peak_gib']:.2f}); launches (K1, K2, K3) {counts}")
    check(all(same), "the mesh's steps are not 5f's bit for bit")
    del state, step, model, w_in, batch
    gc.collect()
    torch.cuda.empty_cache()

    rules = context_parallel_rules()
    cfg13 = gpt.config(SERVE_PRESET, attn_impl="dot")
    model = gpt.init(cfg13, torch.Generator(device=DEVICE).manual_seed(0),
                     DEVICE, mesh=mesh, rules=rules)
    logits = {}
    with registered_mesh(mesh, rules):
        for impl in ("dot", "ring", "ulysses"):
            model.cfg = replace(cfg13, attn_impl=impl)
            before = _counts(fa)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits[impl] = model(buf).float()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            model.reshard()
            check(_counts(fa) == before, f"{impl} attention launched a "
                  f"flash kernel")
            print(f"mesh: {SERVE_PRESET} forward of {tuple(buf.shape)} under "
                  f"context_parallel_rules(), attn_impl={impl!r}: "
                  f"{wall * 1e3:.2f} ms (first call)")
    for impl in ("ring", "ulysses"):
        gap = float((logits[impl] - logits["dot"]).abs().max())
        print(f"mesh: {impl} against dot attention on the sp mesh of one: "
              f"max|dlogit| {gap:.4f} (bound {FLASH_VS_DOT_TOL}), bit-equal "
              f"{torch.equal(logits[impl], logits['dot'])}")
        check(bool(torch.isfinite(logits[impl]).all())
              and gap <= FLASH_VS_DOT_TOL,
              f"{impl} attention's logits disagree with dot's")
    del model, logits
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# -- 5e. checkpoints ----------------------------------------------------------

def _opt_tensors(opt_state):
    """The optimizer state's tensors in a fixed order (the plan's dims and
    the leaf groups are not state)."""
    if isinstance(opt_state, tuple):
        for s in opt_state:
            yield from _opt_tensors(s)
    elif isinstance(opt_state, dict):
        for k in sorted(opt_state):
            if k not in ("dims", "groups"):
                yield from _opt_tensors(opt_state[k])
    else:
        yield opt_state


def _state_fingerprint(torch, state):
    """_fingerprint of every parameter's local block, every optimizer
    tensor (counts included) and the step."""
    from ray_tpu_torch.parallel.sharding import local
    tensors = [local(p) for p in state["params"].parameters()]
    tensors += list(_opt_tensors(state["opt_state"])) + [state["step"]]
    return _fingerprint(torch, {i: t.double() if t.dtype == torch.int32
                                else t for i, t in enumerate(tensors)})


class _PeakRSS:
    """The process's peak resident memory while it runs, from
    /proc/self/status sampled every 5 ms."""

    def __enter__(self):
        self.base = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def _sample(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    @staticmethod
    def _rss():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        fail("no VmRSS in /proc/self/status")


def phase_checkpoint(torch, mesh):
    """Phase 5's recipe on the mesh under tp_fsdp_rules(): save after
    CKPT_STEPS steps, then resume states of other seeds from the
    checkpoint under the same rules (load_for_rank) and under the all-None
    rules (restore_on_mesh); each resumed run's steps must be the
    uninterrupted run's bit for bit. Returns the (K1, K2, K3) launches."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import optim, tp_fsdp_rules
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.sharding import local
    from ray_tpu_torch.train import (CheckpointManager, latest_checkpoint,
                                     restore_train_state, save_train_state)
    from ray_tpu_torch.train._internal import sharded_checkpoint as sc
    from ray_tpu_torch.train.torch.checkpoint import restore_route

    cfg = gpt.config(TRAIN_PRESET, **TRAIN_OVERRIDES)
    batch = _train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, 0, DEVICE)
    per_layer = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    per_step = []

    def fresh(rules, seed):
        opt = ts.memory_efficient_optimizer(learning_rate=1e-4)
        return (ts.init_train_state(cfg, mesh, rules, opt, seed=seed,
                                    device=DEVICE),
                ts.make_train_step(cfg, mesh, rules, opt))

    def steps(state, step):
        losses, prints = [], []
        for _ in range(CKPT_STEPS):
            counts0 = _counts(fa)
            state, metrics = step(state, batch)
            per_step.append(tuple(b - a for a, b in
                                  zip(counts0, _counts(fa))))
            losses.append(float(metrics["loss"]))
            prints.append(_state_fingerprint(torch, state))
        return state, losses, prints

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        _zero_counts(fa)
        state, step = fresh(tp_fsdp_rules(), seed=0)
        state, _, _ = steps(state, step)
        torch.cuda.synchronize()
        saved = _state_fingerprint(torch, state)
        manager = CheckpointManager(root, "chip-smoke")
        with _PeakRSS() as rss:
            t0 = time.perf_counter()
            handle = save_train_state(state, manager, mesh, tp_fsdp_rules())
            save_s = time.perf_counter() - t0
        check(handle is not None, "the save committed no checkpoint")
        on_disk = sum(f.stat().st_size for f in pathlib.Path(root).iterdir())
        shard_bytes = sum(s["bytes"] for s in handle.manifest["shards"])
        free = shutil.disk_usage(root).free
        print(f"ckpt: {TRAIN_PRESET} Adafactor state after {CKPT_STEPS} "
              f"steps saved as seq {handle.seq}: "
              f"{len(handle.manifest['params'])} leaves, {shard_bytes} "
              f"bytes of shard, {on_disk} bytes on disk in {save_s:.3f} s "
              f"({on_disk / save_s / 1e9:.3f} GB/s, "
              f"device-to-host copies, crc32s and fsync included); host RSS "
              f"{rss.base / 2**30:.2f} GiB before, peak {rss.peak / 2**30:.2f}"
              f" GiB during the save (+{(rss.peak - rss.base) / 2**30:.2f}); "
              f"{free / 2**30:.1f} GiB free in {tempfile.gettempdir()}")
        # Where the save's time goes: the state laid out on the host alone,
        # and one crc32 pass over it (write_shard takes two).
        model = state["params"]
        groups = gpt.leaf_groups(model)
        t0 = time.perf_counter()
        host, _ = sc.flatten_tree({
            "params": optim.to_jax_tree({n: local(p) for n, p in
                                         model.named_parameters()},
                                        groups, "cpu"),
            "opt_state": optim.to_optax_state(state["opt_state"], groups,
                                              "cpu")})
        layout_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for t in host.values():
            zlib.crc32(t.numpy())
        crc_s = time.perf_counter() - t0
        del host, model
        print(f"ckpt: of the save, the layout on the host (device-to-host "
              f"copies, layers stacked) alone takes {layout_s:.3f} s and "
              f"one crc32 pass {crc_s:.3f} s; write_shard takes two passes, "
              f"the rest is its bytes copy, the write and fsync, and the "
              f"commit")
        state, ref_losses, ref_prints = steps(state, step)
        print(f"ckpt: uninterrupted run's losses after the save "
              f"{ref_losses}")
        del state, step
        gc.collect()
        torch.cuda.empty_cache()

        for rules_name, rules, seed, route in (
                ("tp_fsdp_rules()", tp_fsdp_rules(), 1, "load_for_rank"),
                ("rules all None (bench.py)", _all_rules(), 2,
                 "restore_on_mesh")):
            state, step = fresh(rules, seed)
            ckpt = latest_checkpoint(manager)
            check(ckpt is not None and ckpt.uri == handle.uri,
                  f"latest_checkpoint is {ckpt}, not {handle}")
            got = restore_route(ckpt, state, mesh, rules)
            check(got == route, f"{rules_name}: restore route {got}, "
                  f"expected {route}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = restore_train_state(state, ckpt, mesh, rules)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(torch.equal(_state_fingerprint(torch, state), saved),
                  f"{rules_name}: the restored state's fp64 sums and norms "
                  f"differ from the saved state's")
            state, losses, prints = steps(state, step)
            check(losses == ref_losses and all(
                torch.equal(a, b) for a, b in zip(prints, ref_prints)),
                f"{rules_name}: resumed losses {losses} against the "
                f"uninterrupted {ref_losses}, fingerprints equal: "
                f"{[torch.equal(a, b) for a, b in zip(prints, ref_prints)]}")
            print(f"ckpt: {rules_name}: restored by {route} in "
                  f"{restore_s:.3f} s ({shard_bytes / restore_s / 1e9:.3f} "
                  f"GB/s of shard read, crc32s and host-to-device copies "
                  f"included); every tensor's fp64 sum and norm equal to "
                  f"the saved state's; {CKPT_STEPS} steps' losses {losses} "
                  f"and fingerprints bit-equal to the uninterrupted run's")
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not os.path.exists(root), f"{root} was not deleted")
    counts = _counts(fa)
    check(all(c == per_layer for c in per_step),
          f"launches per step (K1, K2, K3) {per_step}, expected {per_layer}")
    print(f"ckpt: launches over {len(per_step)} steps (K1, K2, K3) {counts} "
          f"= {per_layer} per step")
    return counts


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


# -- 4e, 5h. the model zoo -------------------------------------------------

def _unet_sampler(torch, serve, diffusion, model, max_batch):
    """What examples/serve_diffusion.py deploys, without the runtime: an
    object whose @serve.batch method takes one x_T per request and runs
    one DDIM call per coalesced batch."""
    class Sampler:
        @serve.batch(max_batch_size=max_batch, batch_wait_timeout_s=0.05)
        async def __call__(self, x_T_list):
            x_T = torch.stack(x_T_list)
            return list(diffusion.ddim_sample(model, None, len(x_T_list),
                                              DIFF_STEPS, x_T=x_T))
    return Sampler()


def phase_diffusion_serving(torch):
    """ddpm-cifar and sd-base (bf16 compute over fp32 parameters, seeded
    random weights) served through the port's @serve.batch: concurrent
    requests coalesce into one 50-step DDIM call; then the same x_T
    sampled in fp32 on the card, and the bf16 images held to it."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import diffusion
    from ray_tpu_torch.ops import flash_attention as fa

    _zero_counts(fa)
    for preset, batch in DIFF_SERVE:
        cfg = diffusion.config(preset)
        model = diffusion.init(
            cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
        shape = (batch, cfg.image_size, cfg.image_size, cfg.in_channels)
        x_T = torch.randn(shape, generator=torch.Generator(
            device=DEVICE).manual_seed(1), device=DEVICE)
        n_params = sum(p.numel() for p in model.parameters())
        diffusion.ddim_sample(model, None, batch, 2, x_T=x_T)  # warm
        torch.cuda.synchronize()
        sampler = _unet_sampler(torch, serve, diffusion, model, batch)

        async def requests():
            return await asyncio.gather(*(sampler(x) for x in x_T))

        t0 = time.perf_counter()
        images = torch.stack(asyncio.run(requests()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = type(sampler).__call__.batch_stats(sampler)
        check(stats["batches"] == 1 and stats["last_batch_size"] == batch,
              f"{preset}: {batch} concurrent requests ran as "
              f"{stats['batches']} batches (last {stats['last_batch_size']})")
        check(images.shape == shape and bool(torch.isfinite(images).all()),
              f"{preset}: images of shape {tuple(images.shape)}, or not "
              f"finite")
        ref_model = diffusion.UNet(diffusion.config(
            preset, dtype=torch.float32), DEVICE)
        ref_model.load_state_dict(model.state_dict())
        t1 = time.perf_counter()
        ref = diffusion.ddim_sample(ref_model, None, batch, DIFF_STEPS,
                                    x_T=x_T)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t1
        gap = float((images - ref).abs().max())
        rms = float((images - ref).pow(2).mean().sqrt())
        print(f"serve: {preset} ({n_params:,} params, stages "
              f"{cfg.stage_channels} at {cfg.image_size}x{cfg.image_size}x"
              f"{cfg.in_channels}), bf16: {batch} concurrent requests -> "
              f"batch_stats {stats['batches']} batch of "
              f"{stats['last_batch_size']}; {DIFF_STEPS} DDIM steps in "
              f"{wall * 1e3:.2f} ms: {batch / wall:.2f} images/s, "
              f"{wall / DIFF_STEPS * 1e3:.3f} ms per DDIM step (host clock, "
              f"synchronised); fp32 on the card {ref_wall * 1e3:.2f} ms; "
              f"max|bf16 - fp32| {gap:.4f} (RMS {rms:.5f}, bound "
              f"{DIFF_BF16_TOL}), max|pixel| {float(ref.abs().max()):.3f}")
        check(gap <= DIFF_BF16_TOL,
              f"{preset}: bf16 images {gap} from the fp32 sampler's")
        def forward():
            with torch.inference_mode():
                diffusion.forward(model, x_T,
                                  torch.full((batch,), 999, device=DEVICE))
        _profile(torch, forward,
                 f"one bf16 UNet forward of {preset} at batch {batch}", 8,
                 convs=True)
        del model, ref_model, images, ref
        gc.collect()
        torch.cuda.empty_cache()
    check(_counts(fa) == (0, 0, 0), "the UNet launched a flash kernel")

    # unet-tiny in fp32, card against CPU.
    cfg = diffusion.config("unet-tiny")
    cpu = diffusion.init(cfg, torch.Generator().manual_seed(0), "cpu")
    card = diffusion.UNet(cfg, DEVICE)
    card.load_state_dict(cpu.state_dict())
    x_T = torch.randn((2, 16, 16, 3),
                      generator=torch.Generator().manual_seed(1))
    t = torch.tensor([3, 40])
    with torch.inference_mode():
        fwd = float((card(x_T.to(DEVICE), t.to(DEVICE)).cpu()
                     - cpu(x_T, t)).abs().max())
    ref = diffusion.ddim_sample(cpu, None, 2, 10, x_T=x_T)
    got = diffusion.ddim_sample(card, None, 2, 10, x_T=x_T.to(DEVICE)).cpu()
    sample = float((got - ref).abs().max())
    print(f"unet-tiny fp32, card vs CPU: forward max|d| {fwd:.3e}, 10-step "
          f"DDIM sample max|d| {sample:.3e} (bound {UNET_TINY_TOL:.0e})")
    check(fwd <= UNET_TINY_TOL and sample <= UNET_TINY_TOL,
          "unet-tiny on the card disagrees with the CPU")


# -- 4f-4h. deployments, the ported example, the CLI --------------------------

class _GptReplica:
    """4f's deployment: gpt-1.3b from phase 4's seed with phase 4's decode
    engine (``_decode_engine``), built where the replica runs. A request
    is a prompt, or an HTTP request whose JSON body holds one."""

    def __init__(self):
        import torch

        import ray_tpu_torch
        from ray_tpu_torch import serve
        from ray_tpu_torch.models import gpt
        t0 = time.perf_counter()
        if DEVICE == "cuda":
            # As phase 1 sets them in this script's process.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        cfg = gpt.config(SERVE_PRESET, attn_impl="flash")
        self.model = gpt.init(cfg, torch.Generator(device=DEVICE).manual_seed(
            0), device=DEVICE).eval()
        self.engine, self.state = _decode_engine(torch, self.model, serve)
        with torch.inference_mode():  # warm-up, as phase 4's
            self.model(self.state["buf"])
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        # The lease's ids, read where the replica is built: a sync method
        # runs on a thread of its own, which has no task context.
        self.where = {"pid": os.getpid(), "gpu_ids": ray_tpu_torch.get_gpu_ids(),
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                      "device": str(next(self.model.parameters()).device),
                      "init_s": time.perf_counter() - t0}

    async def __call__(self, prompt):
        if hasattr(prompt, "json"):  # through the HTTP proxy
            prompt = prompt.json()["prompt"]
        return await self.engine.submit(prompt, max_new_tokens=MAX_NEW)

    def zero_counts(self):
        from ray_tpu_torch.ops import flash_attention as fa
        _zero_counts(fa)

    def stats(self):
        from ray_tpu_torch.ops import flash_attention as fa
        return {**self.engine.stats(), **self.where,
                "launches": _counts(fa)}


def _send_requests(ray_tpu_torch, handle, prompts, arrival_steps):
    """Each prompt through ``handle``: prompt i once the replica's engine
    has run ``arrival_steps * i`` steps (all at once for 0). Returns
    ``answers(what)``, which waits for every answer and returns the
    tokens, each request's latency in s and the wall time from the first
    request."""
    tokens, latency, errors, threads = ([None] * len(prompts),
                                        [None] * len(prompts), [], [])

    def wait(i, ref, t0):
        try:
            tokens[i] = ray_tpu_torch.get(ref, timeout=300)
            latency[i] = time.perf_counter() - t0
        except Exception as exc:  # noqa: BLE001 - reported by answers()
            errors.append(exc)

    t_start = time.perf_counter()
    for i, prompt in enumerate(prompts):
        while arrival_steps and ray_tpu_torch.get(
                handle.stats.remote(), timeout=300)["iterations"] \
                < arrival_steps * i:
            time.sleep(0.002)
        t0 = time.perf_counter()
        threads.append(threading.Thread(
            target=wait, args=(i, handle.remote(prompt), t0)))
        threads[-1].start()

    def answers(what):
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t_start
        check(not errors, f"4f {what}: requests failed: {errors[:3]}")
        check(all(t is not None for t in tokens),
              f"4f {what}: a request was not answered")
        return tokens, latency, wall
    return answers


def phase_deployment(torch, served):
    """4f: gpt-1.3b through a deployment replica in a worker process on a
    DEPLOY_GPUS lease of the card: (a) phase 4's prompts at phase 4's
    staggered arrival through a DeploymentHandle, bit-equal to phase 4's
    tokens, one joining a running batch, K1 once per layer per step in the
    replica's process; (b) a redeploy of a new version while 8 more are in
    flight, every one answered with phase 4's tokens; (c) one request
    through the HTTP proxy; (d) serve.delete gives the card's memory back.
    Returns (a)'s K1 launches."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt

    cfg = gpt.config(SERVE_PRESET, attn_impl="flash")
    prompts, want = served["prompts"], served["tokens"]
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    _worker_imports_this_checkout()
    ray_tpu_torch.init(num_cpus=4)
    try:
        dep = serve.deployment(_GptReplica, name="gpt", version="v1",
                               ray_actor_options={
                                   "num_gpus": DEPLOY_GPUS if DEVICE == "cuda"
                                   else 0,
                                   "runtime_env": {"worker_process": True}})
        t0 = time.perf_counter()
        handle = serve.run(dep.bind())
        start_s = time.perf_counter() - t0
        where = ray_tpu_torch.get(handle.stats.remote())
        check(where["pid"] != os.getpid(), "4f: the replica runs in this "
              "process")
        if DEVICE == "cuda":
            check(where["gpu_ids"] == [0] and where["visible"] == "0"
                  and where["device"] == "cuda:0",
                  f"4f: the replica holds GPU ids {where['gpu_ids']}, sees "
                  f"CUDA_VISIBLE_DEVICES {where['visible']!r} and serves on "
                  f"{where['device']}")

        # (a) phase 4's requests at phase 4's arrival.
        ray_tpu_torch.get(handle.zero_counts.remote())
        tokens, latency, wall = _send_requests(
            ray_tpu_torch, handle, prompts, ARRIVAL_STEPS)("(a)")
        stats = ray_tpu_torch.get(handle.stats.remote())
        steps, (launches, dq_n, dkv_n) = stats["iterations"], stats["launches"]
        differ = [i for i, (a, b) in enumerate(zip(tokens, want)) if a != b]
        check(not differ, f"4f (a): requests {differ} got tokens other than "
              f"phase 4's: {[tokens[i] for i in differ]} against "
              f"{[want[i] for i in differ]}")
        check(stats["admitted_running"] >= 1,
              "4f (a): no request joined a running batch")
        check(launches == cfg.n_layers * steps and dq_n == dkv_n == 0,
              f"4f (a): the replica launched (K1, K2, K3) {stats['launches']}"
              f" over {steps} steps, expected {cfg.n_layers} K1 a step")
        lat = sorted(latency)
        print(f"deploy: {SERVE_PRESET} in a worker-process replica (pid "
              f"{where['pid']}, this process {os.getpid()}) on a "
              f"{DEPLOY_GPUS} GPU lease, ids {where['gpu_ids']}, "
              f"CUDA_VISIBLE_DEVICES {where['visible']!r}, {where['device']};"
              f" serve.run to ready {start_s:.2f} s (the replica built its "
              f"model in {where['init_s']:.2f} s); {CARD}")
        print(f"deploy: (a) {N_REQUESTS} requests, one every {ARRIVAL_STEPS} "
              f"steps, through a DeploymentHandle: tokens bit-equal to phase "
              f"4's; {steps} steps in {wall:.3f} s ({wall / steps * 1e3:.2f} "
              f"ms/step, {N_REQUESTS * MAX_NEW / wall:.2f} tokens/s) against "
              f"phase 4's {served['steps']} steps at {served['ms_step']:.2f} "
              f"ms/step, {served['tokens_s']:.2f} tokens/s; latency p50 "
              f"{statistics.median(lat) * 1e3:.1f} ms, p99 "
              f"{lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3:.1f} ms;"
              f" K1 launches in the replica {launches} = {cfg.n_layers} x "
              f"{steps}; admitted into a running batch "
              f"{stats['admitted_running']}; {CARD}")

        # (b) a new version while 8 requests are in flight.
        answers = _send_requests(ray_tpu_torch, handle, prompts, 0)
        t0 = time.perf_counter()
        serve.run(dep.options(version="v2").bind())
        redeploy_s = time.perf_counter() - t0
        tokens, latency, _ = answers("(b)")
        differ = [i for i, (a, b) in enumerate(zip(tokens, want)) if a != b]
        check(not differ, f"4f (b): requests {differ} answered across the "
              f"redeploy got tokens other than phase 4's")
        from ray_tpu_torch.serve._private.controller import \
            get_or_create_controller
        states = ray_tpu_torch.get(
            get_or_create_controller().replica_states.remote("gpt"))
        running = [s for s in states if s["state"] == "RUNNING"]
        check([s["version"] for s in running] == ["v2"],
              f"4f (b): running replicas after the redeploy {states}")
        after = ray_tpu_torch.get(handle.remote(prompts[0]), timeout=300)
        check(after == want[0], "4f (b): the new version's replica answers "
              "other tokens")
        lat = sorted(latency)
        print(f"deploy: (b) redeploy to v2 with {N_REQUESTS} requests in "
              f"flight: serve.run {redeploy_s:.2f} s (the new replica started"
              f" beside the old one, which drained); every request answered "
              f"with phase 4's tokens, latency p50 "
              f"{statistics.median(lat) * 1e3:.1f} ms, p99 "
              f"{lat[-1] * 1e3:.1f} ms; the v2 replica answers phase 4's "
              f"tokens; {CARD}")

        # (c) one request through the HTTP proxy.
        import urllib.request
        serve.start(port=0)
        port = serve.http_port()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/gpt",
            data=json.dumps({"prompt": prompts[1]}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            body = json.loads(resp.read())
        http_s = time.perf_counter() - t0
        check(body == want[1], f"4f (c): the HTTP answer {body} is not "
              f"phase 4's {want[1]}")
        print(f"deploy: (c) one request through the HTTP proxy on port "
              f"{port}: phase 4's tokens in {http_s * 1e3:.1f} ms")

        # (d) delete: the replica processes and their memory go.
        t0 = time.perf_counter()
        serve.delete("gpt")
        deadline = time.monotonic() + 60
        while torch.cuda.mem_get_info()[0] < free0 - DEPLOY_FREE_SLACK \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        free1 = torch.cuda.mem_get_info()[0]
        check(free1 >= free0 - DEPLOY_FREE_SLACK,
              f"4f (d): {free1 / 2**30:.2f} GiB free after serve.delete "
              f"against {free0 / 2**30:.2f} GiB before 4f")
        print(f"deploy: (d) serve.delete: free card memory "
              f"{free1 / 2**30:.2f} GiB, {free0 / 2**30:.2f} GiB before 4f, "
              f"in {time.perf_counter() - t0:.2f} s")
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    return launches


def phase_example(torch):
    """4g: the ported examples/serve_diffusion.py through its main() at
    EXAMPLE_PRESET, in a runtime of its own: every image back, finite, at
    the preset's shape, from at most 2 batches; the first batch's images
    bit-equal to ddim_sample in this process from the same seeds; the
    replica's model gone with the runtime."""
    from ray_tpu_torch.examples import serve_diffusion
    from ray_tpu_torch.models import diffusion

    gc.collect()
    torch.cuda.empty_cache()
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = serve_diffusion.main(["--preset", EXAMPLE_PRESET, "--requests",
                                str(EXAMPLE_REQUESTS)])
    main_s = time.perf_counter() - t0
    gc.collect()
    alloc1 = torch.cuda.memory_allocated()
    check(alloc1 - alloc0 <= EXAMPLE_ALLOC_SLACK,
          f"4g: {(alloc1 - alloc0) / 2**20:.1f} MiB more allocated after the "
          f"example's shutdown than before it")
    cfg = diffusion.config(EXAMPLE_PRESET)
    shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
    images, batches = out["images"], out["batches"]
    check(len(images) == EXAMPLE_REQUESTS
          and all(i.shape == shape and np.isfinite(i).all() for i in images),
          f"4g: {len(images)} images, shapes "
          f"{sorted({i.shape for i in images})}, or not finite")
    check(1 <= len(batches) <= 2
          and sorted(p for _, b in batches for p in b)
          == sorted(out["prompts"]),
          f"4g: the requests ran as batches {[len(b) for _, b in batches]}")
    seed, prompts = batches[0]
    model = diffusion.init(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                           DEVICE)
    with torch.inference_mode():
        want = diffusion.ddim_sample(
            model, torch.Generator(device=DEVICE).manual_seed(seed),
            len(prompts), n_steps=out["ddim_steps"]).cpu().numpy()
    got = np.stack([images[out["prompts"].index(p)] for p in prompts])
    check(np.array_equal(got, want),
          f"4g: the first batch's images differ from ddim_sample's by up to "
          f"{float(np.abs(got - want).max())}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    steps = len(batches) * out["ddim_steps"]
    print(f"example: serve_diffusion.main --preset {EXAMPLE_PRESET} "
          f"--requests {EXAMPLE_REQUESTS} in {main_s:.2f} s: batches "
          f"{[len(b) for _, b in batches]} (seeds "
          f"{[sd for sd, _ in batches]}), first batch bit-equal to "
          f"ddim_sample here; {EXAMPLE_REQUESTS} images in "
          f"{out['seconds']:.3f} s: {EXAMPLE_REQUESTS / out['seconds']:.2f} "
          f"images/s, {out['seconds'] / steps * 1e3:.3f} ms per DDIM step "
          f"(host clock, through the handle; 4e's direct sampler at 64 "
          f"and 8 images above); allocated {alloc0 / 2**20:.1f} MiB before, "
          f"{alloc1 / 2**20:.1f} MiB after; {CARD}")


def phase_cli():
    """4h: ``python -m ray_tpu_torch.scripts.cli devices`` names the
    card."""
    import torch
    _worker_imports_this_checkout()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "devices"],
        capture_output=True, text=True, timeout=120, cwd=HERE)
    lines = proc.stdout.strip().splitlines()
    name = torch.cuda.get_device_name(0)
    check(proc.returncode == 0 and len(lines) == torch.cuda.device_count()
          and name in lines[0],
          f"4h: `cli devices` exited {proc.returncode} with {lines} "
          f"{proc.stderr.strip()[-300:]}")
    print(f"cli: devices -> {lines} in {time.perf_counter() - t0:.2f} s")


def _zoo_training_cases(torch):
    """(preset, module, config, make_batch(generator) -> the loss's
    arguments after the model, loss(model, *batch) -> 0-d tensor, what an
    item of the batch is) of phase 5h."""
    from ray_tpu_torch.models import bert, diffusion, t5, vit
    B = ZOO_BATCH

    def unet_batch(g):
        return (torch.rand((B["ddpm-cifar"], 32, 32, 3), generator=g,
                           device=DEVICE) * 2 - 1, g)

    def vit_batch(g):
        n = B["vit-b16"]
        return (torch.randn((n, 224, 224, 3), generator=g, device=DEVICE),
                torch.randint(0, 1000, (n,), generator=g, device=DEVICE))

    def bert_batch(g):
        shape = (B["bert-base"], 512)
        targets = torch.randint(0, 30522, shape, generator=g, device=DEVICE)
        masked = torch.rand(shape, generator=g, device=DEVICE) < 0.15
        return (torch.where(masked, 103, targets), targets, masked.float())

    def t5_batch(g):
        n = B["t5-base"]
        return tuple(torch.randint(0, 32128, (n, s), generator=g,
                                   device=DEVICE) for s in (512, 128, 128))

    return [
        ("ddpm-cifar", diffusion, diffusion.config("ddpm-cifar"), unet_batch,
         lambda m, images, g: diffusion.loss_fn(m, images, g)[0],
         "images 32x32x3"),
        ("vit-b16", vit, vit.config("vit-b16"), vit_batch,
         lambda m, *b: vit.loss_fn(m, *b)[0], "images 224x224x3"),
        ("bert-base", bert, bert.config("bert-base"), bert_batch,
         bert.mlm_loss, "sequences of 512, 15% masked"),
        ("t5-base", t5, t5.config("t5-base"), t5_batch,
         lambda m, *b: t5.loss_fn(m, *b)[0], "pairs of 512 + 128 tokens"),
    ]


def _zoo_step(torch, optim, loss_fn, model, params, opt, opt_state, batch):
    """One training step: the loss, its gradients (zeros where the loss
    does not reach a parameter, as jax.grad's), AdamW's update in place."""
    loss = loss_fn(model, *batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    unused = [n for n, g in zip(params, grads) if g is None]
    with torch.no_grad():
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        updates, opt_state = opt.update(grads, opt_state, params)
        optim.apply_updates(params, updates)
    return opt_state, loss.detach(), unused


def phase_zoo_training(torch):
    """ddpm-cifar, vit-b16, bert-base and t5-base trained at full width
    (bf16 compute over fp32 parameters, the presets' own remat) with the
    port's AdamW at weight decay 0: 2 warm-up and 4 timed steps each.
    Returns phase 5i's reference of each: the initial weights' fingerprint,
    each step's loss, the parameters after the first step (on the card),
    ms per step, items/s, peak memory above what was held before it, and
    one profiled step's device time and kernel launches."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import optim

    _zero_counts(fa)
    ref = {}
    for (preset, module, cfg, make_batch, loss_fn,
         what) in _zoo_training_cases(torch):
        items = ZOO_BATCH[preset]
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = module.init(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                            DEVICE)
        params = dict(model.named_parameters())
        opt = optim.adamw(lambda c: torch.full((), ZOO_LR, device=DEVICE),
                          weight_decay=0.0)
        opt_state = opt.init(params, module.leaf_groups(model))
        batch = make_batch(torch.Generator(device=DEVICE).manual_seed(1))
        before = _fingerprint(torch, params)
        n_params = sum(p.numel() for p in params.values())
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        losses, step_s = [], []
        for i in range(ZOO_WARMUP + ZOO_STEPS):
            if i == ZOO_WARMUP:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            opt_state, loss, unused = _zoo_step(
                torch, optim, loss_fn, model, params, opt, opt_state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
            if i == 0:
                after1 = {n: p.detach().clone() for n, p in params.items()}
        peak = torch.cuda.max_memory_allocated()
        moved = (_fingerprint(torch, params) != before).any(dim=1).tolist()
        still = [n for n, m in zip(params, moved) if not m]
        loss0, tol = ZOO_LOSS0[preset]
        timed = step_s[ZOO_WARMUP:]
        mean_s = statistics.mean(timed)
        print(f"train: {preset} ({n_params:,} params), batch {items} "
              f"{what}, remat {getattr(cfg, 'remat', False)}, AdamW lr "
              f"{ZOO_LR} wd 0; initialised in {init_s:.2f} s; losses "
              f"{[round(x, 5) for x in losses]} (step 0 within {tol} of "
              f"{loss0}); {ZOO_STEPS} timed steps "
              f"{[round(t * 1e3, 2) for t in timed]} ms, mean "
              f"{mean_s * 1e3:.2f} ms/step (std "
              f"{statistics.pstdev(timed) * 1e3:.2f}), {items / mean_s:.2f} "
              f"items/s; peak memory {peak / 2**30:.2f} GiB; the loss does "
              f"not reach {unused or 'none'}")
        check(np.isfinite(losses).all() and abs(losses[0] - loss0) <= tol,
              f"{preset}: step-0 loss {losses[0]} is not within {tol} of "
              f"{loss0}")
        check(set(still) == set(unused),
              f"{preset}: parameters {sorted(set(still) ^ set(unused))} "
              f"moved against their gradients' reach")
        stats = {}
        device_ms = _profile(
            torch, lambda: _zoo_step(torch, optim, loss_fn, model, params,
                                     opt, opt_state, batch),
            f"one training step of {preset}", 10, convs=True, stats=stats)
        ref[preset] = {"init": before, "losses": losses, "after1": after1,
                       "ms": mean_s * 1e3, "items_s": items / mean_s,
                       "peak_gib": (peak - base) / 2**30,
                       "device_ms": device_ms, "kernels": stats["kernels"]}
        del model, params, opt_state, batch, after1
        gc.collect()
        torch.cuda.empty_cache()
    check(_counts(fa) == (0, 0, 0), "the zoo's models launched a flash "
          "kernel")
    return ref


def phase_zoo_small(torch):
    """vit-tiny, bert-tiny and t5-tiny in fp32 on the card against the CPU
    from the same weights and inputs: the forward and the first
    gradients."""
    from ray_tpu_torch.models import bert, t5, vit
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 256, (2, 16), generator=g)
    mask = torch.ones((2, 16), dtype=torch.long)
    mask[1, 10:] = 0
    cases = {
        "vit-tiny": (vit, lambda m, *b: vit.forward(m, b[0]),
                     lambda m, *b: vit.loss_fn(m, *b)[0],
                     (torch.randn((2, 32, 32, 3), generator=g),
                      torch.randint(0, 10, (2,), generator=g))),
        "bert-tiny": (bert, lambda m, *b: bert.mlm_logits(
                          m, b[0], attention_mask=b[3]), bert.mlm_loss,
                      (tokens, torch.randint(0, 256, (2, 16), generator=g),
                       (torch.rand((2, 16), generator=g) < 0.25).float(),
                       mask)),
        "t5-tiny": (t5, lambda m, *b: t5.forward(m, b[0], b[1]),
                    lambda m, *b: t5.loss_fn(m, *b)[0],
                    (torch.randint(0, 256, (2, 24), generator=g),
                     torch.randint(0, 256, (2, 12), generator=g),
                     torch.randint(0, 256, (2, 12), generator=g)))}
    for preset, (module, fwd, loss_fn, batch) in cases.items():
        cfg = module.config(preset)
        cpu = module.init(cfg, torch.Generator().manual_seed(0), "cpu")
        card = type(cpu)(cfg, DEVICE)
        card.load_state_dict(cpu.state_dict())
        on_card = [x.to(DEVICE) for x in batch]
        with torch.inference_mode():
            ref, got = fwd(cpu, *batch), fwd(card, *on_card).cpu()
        logit_err = float((got - ref).abs().max())
        grads = []
        for model, b in ((cpu, batch), (card, on_card)):
            grads.append(torch.autograd.grad(
                loss_fn(model, *b), list(model.parameters()),
                allow_unused=True))
        floor = ZOO_GRAD_FLOOR * max(float(a.norm()) for a in grads[0]
                                     if a is not None)
        grad_err = max(float((b.cpu() - a).norm()) / max(float(a.norm()),
                                                          floor)
                       for a, b in zip(*grads) if a is not None)
        print(f"{preset} fp32, card vs CPU: max|dlogit| {logit_err:.3e}, "
              f"max over tensors of |dgrad| / |grad| {grad_err:.3e} (bound "
              f"{ZOO_TINY_TOL:.0e})")
        check(bool(((got - ref).abs() <= ZOO_TINY_TOL
                    + ZOO_TINY_TOL * ref.abs()).all())
              and grad_err <= ZOO_TINY_TOL,
              f"{preset} on the card disagrees with the CPU")


def _zoo_mesh_step(torch, module, loss_fn, model, params, opt, opt_state,
                   batch, mesh, rules):
    """One training step on the mesh, as a user composes it: with the
    mesh and rules current the loss, backward (FSDP2 reduces each
    gradient into its sharded parameter and averages over the data ranks,
    so the loss share is scaled by the count of batch blocks, 1 here),
    and ``average_replicated_grads`` with the model's ``batch_spec`` (the
    gradients of the parameters outside FSDP2 averaged, and summed over
    ``sp`` where the model's sequence is split over more than one rank:
    never here); then AdamW's update in place → (the optimizer's state,
    the loss)."""
    from ray_tpu_torch.models._common import batch_blocks
    from ray_tpu_torch.parallel import optim
    from ray_tpu_torch.parallel.mesh import registered_mesh
    from ray_tpu_torch.parallel.sharding import average_replicated_grads
    with registered_mesh(mesh, rules):
        loss = loss_fn(model, *batch)
        (loss * batch_blocks(module.batch_spec)).backward()
        average_replicated_grads(params.values(), module.batch_spec)
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in params.items()}
    for p in params.values():
        p.grad = None
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, params)
        optim.apply_updates(params, updates)
    return opt_state, loss.detach()


def _zoo_mesh_state(torch, module, cfg, mesh, rules, seed):
    """(model, its parameters, AdamW, AdamW's state) of ``module`` placed
    on the mesh by ``rules``, drawn from ``seed`` as phase 5h draws."""
    from ray_tpu_torch.parallel import optim
    model = module.init(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                        DEVICE, mesh=mesh, rules=rules)
    params = dict(model.named_parameters())
    opt = optim.adamw(lambda c: torch.full((), ZOO_LR, device=DEVICE),
                      weight_decay=0.0)
    return model, params, opt, opt.init(params, module.leaf_groups(model))


def _zoo_mesh_run(torch, mesh, case, rules_name, rules, mine, against):
    """One model of phase 5h (``case``) placed on the mesh by ``rules``
    from 5h's seed, ZOO_MESH_WARMUP warm-up and ZOO_MESH_STEPS timed
    steps and a profiled one: its
    weights against 5h's fingerprint, its losses and first update against
    ``mine`` (the reference run's, named ``against``): bit for bit for the
    models of ``ZOO_MESH_EXACT``, else the step-0 loss bit-equal, later
    losses within ``ZOO_MESH_LOSS_RTOL`` and the first update within 2 lr.
    Returns (this run's reference, as 5h's; the model; its AdamW; its
    state; the batch)."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import local

    preset, module, cfg, make_batch, loss_fn, _ = case
    items = ZOO_BATCH[preset]
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, params, opt, opt_state = _zoo_mesh_state(
        torch, module, cfg, mesh, rules, 0)
    batch = make_batch(torch.Generator(device=DEVICE).manual_seed(1))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(isinstance(model, FSDPModule)
          and all(isinstance(u, FSDPModule) for u in model.fsdp_units())
          and all(isinstance(p, DTensor) for p in params.values()),
          f"{preset}: the model is not placed by FSDP2 and DTensor")
    blocks = {n: local(p) for n, p in params.items()}
    check(torch.equal(_fingerprint(torch, blocks), mine["init"]),
          f"{preset}: the weights initialised on the mesh differ from "
          f"phase 5h's")

    def step():
        return _zoo_mesh_step(torch, module, loss_fn, model, params, opt,
                              opt_state, batch, mesh, rules)
    losses, step_s = [], []
    t_run = time.perf_counter()
    for i in range(ZOO_MESH_WARMUP + ZOO_MESH_STEPS):
        if i == ZOO_MESH_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        opt_state, loss = step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if i == 0:
            with torch.no_grad():
                after1 = {n: local(p).detach().clone()
                          for n, p in params.items()}
                diffs = [(after1[n] - mine["after1"][n]).abs()
                         for n in params]
                n_diff = sum(int((d != 0).sum()) for d in diffs)
                max_diff = max(float(d.max()) for d in diffs)
            del diffs
    peak = torch.cuda.max_memory_allocated() - base
    rel = [abs(a / b - 1) for a, b in zip(losses, mine["losses"])]
    print(f"mesh: {preset} under {rules_name}: initialised in "
          f"{init_s:.2f} s, weights equal to 5h's; losses "
          f"{[round(x, 6) for x in losses]}; max rel dloss against "
          f"{against}'s steps {max(rel):.3e}; after the first step "
          f"{n_diff} parameter elements differ from {against}'s, by up to "
          f"{max_diff:.3e}")
    if preset in ZOO_MESH_EXACT:
        check(losses == mine["losses"][:len(losses)] and n_diff == 0,
              f"{preset}: the mesh's steps are not {against}'s bit for bit")
    else:
        check(losses[0] == mine["losses"][0]
              and max(rel) <= ZOO_MESH_LOSS_RTOL
              and max_diff <= 2 * ZOO_LR,
              f"{preset}: the mesh's losses {losses} against {against}'s "
              f"{mine['losses']}, the first update up to {max_diff}")
    timed = step_s[ZOO_MESH_WARMUP:]
    mean_s = statistics.mean(timed)
    stats = {}
    steps_s = time.perf_counter() - t_run

    def profiled():
        nonlocal opt_state
        opt_state, _ = step()
    t0 = time.perf_counter()
    device_ms = _profile(
        torch, profiled,
        f"one training step of {preset} on the mesh, {rules_name}", 10,
        convs=True, stats=stats)
    profile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops = _dispatched(torch, profiled)
    ops_s = time.perf_counter() - t0
    print(f"mesh: {preset}, {rules_name}: seconds: init {init_s:.1f}, "
          f"{ZOO_MESH_WARMUP + ZOO_MESH_STEPS} steps and the checks "
          f"{steps_s:.1f}, "
          f"the profile {profile_s:.1f}, the operator count {ops_s:.1f}")
    added = ("not measured" if device_ms is None or mine["device_ms"]
             is None else f"{device_ms - mine['device_ms']:.3f} ms")
    print(f"mesh: {preset}, {rules_name}: {ZOO_MESH_STEPS} timed steps "
          f"{[round(t * 1e3, 2) for t in timed]} ms; mean "
          f"{mean_s * 1e3:.2f} ms/step ({against}: {mine['ms']:.2f}), "
          f"{items / mean_s:.2f} items/s ({against}: "
          f"{mine['items_s']:.2f}); peak {peak / 2**30:.2f} GiB above the "
          f"memory held before ({against}: {mine['peak_gib']:.2f}); "
          f"{stats['kernels']} kernels in a profiled step ({against}: "
          f"{mine.get('kernels', 'not counted')}), {sum(ops.values())} "
          f"operators dispatched a step; against {against} the mesh adds "
          f"{added} of device time to a step")
    ref = {"init": mine["init"], "losses": losses, "after1": after1,
           "ms": mean_s * 1e3, "items_s": items / mean_s,
           "peak_gib": peak / 2**30, "device_ms": device_ms,
           "kernels": stats["kernels"], "ops": ops}
    return ref, model, opt, opt_state, batch


def phase_zoo_mesh(torch, mesh, ref):
    """Phase 5h's models through prepare_mesh's 1-rank mesh (ViT, BERT and
    T5 under tp_fsdp_rules(), the UNet under dp_rules()), initialised from
    5h's seed: the weights, each step's loss and the parameters after the
    first step against 5h's (``ref``), ms per step, items/s, peak memory
    and a step's device time beside 5h's; then t5-base's state saved and
    resumed by both routes. Returns phase 5k's reference of each model,
    as 5h's."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import dp_rules, tp_fsdp_rules

    _zero_counts(fa)
    mine = {}
    for case in _zoo_training_cases(torch):
        preset, module, cfg, _, loss_fn, _ = case
        rules_name, rules = (("dp_rules()", dp_rules())
                             if preset == "ddpm-cifar"
                             else ("tp_fsdp_rules()", tp_fsdp_rules()))
        mine[preset], model, _, opt_state, batch = _zoo_mesh_run(
            torch, mesh, case, rules_name, rules, ref[preset], "5h")
        if preset == "t5-base":
            state = {"params": model, "opt_state": opt_state,
                     # the timed steps, the profile's two, the count's
                     "step": torch.full((), ZOO_MESH_WARMUP
                                        + ZOO_MESH_STEPS + 3,
                                        dtype=torch.int32, device=DEVICE)}
            del model, opt_state
            _timed("5i (t5-base's checkpoint)", _zoo_checkpoint, torch,
                   mesh, module, cfg, loss_fn, state, batch)
            del state
        else:
            del model, opt_state
        del batch
        gc.collect()
        torch.cuda.empty_cache()
    check(_counts(fa) == (0, 0, 0), "the zoo's models launched a flash "
          "kernel on the mesh")
    return mine


def phase_zoo_context_parallel(torch, mesh, ref):
    """Phase 5i's runs again, every model placed by
    ``context_parallel_rules()`` (BERT's and T5's sequence on ``sp``, an
    axis of one rank here; ViT's and the UNet's images never split): the
    losses and first update against 5i's (``ref``) by 5i's bounds, the
    operators a step dispatches equal to 5i's (over an ``sp`` of one the
    split adds no work: every kernel is launched by one of them), ms per
    step, items/s and peak memory beside 5i's."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import context_parallel_rules

    _zero_counts(fa)
    for case in _zoo_training_cases(torch):
        preset = case[0]
        mine = ref[preset]
        got, model, _, opt_state, batch = _zoo_mesh_run(
            torch, mesh, case, "context_parallel_rules()",
            context_parallel_rules(), mine, "5i")
        differ = {k: (mine["ops"][k], got["ops"][k])
                  for k in set(mine["ops"]) | set(got["ops"])
                  if mine["ops"][k] != got["ops"][k]}
        for k, (a, b) in sorted(differ.items())[:20]:
            print(f"  dispatched {k[:160]}: 5i x{a}, 5k x{b}")
        check(not differ, f"{preset}: a step under context_parallel_rules() "
              f"dispatches {sum(got['ops'].values())} operators, 5i's "
              f"{sum(mine['ops'].values())}, {len(differ)} kinds differ")
        del model, opt_state, batch, got
        gc.collect()
        torch.cuda.empty_cache()
    check(_counts(fa) == (0, 0, 0), "the zoo's models launched a flash "
          "kernel under context_parallel_rules()")


def _zoo_checkpoint(torch, mesh, module, cfg, loss_fn, state, batch):
    """``state`` (t5-base's on the mesh, tp_fsdp_rules()) saved into a
    temporary directory, then one more step as the reference; states of
    other seeds resume it under the same rules (load_for_rank) and under
    the all-None rules (restore_on_mesh), and their next step must be the
    reference's bit for bit."""
    from ray_tpu_torch.parallel import optim, tp_fsdp_rules
    from ray_tpu_torch.train import (CheckpointManager, latest_checkpoint,
                                     restore_train_state, save_train_state)
    from ray_tpu_torch.train.torch.checkpoint import restore_route

    def step(st, rules, opt):
        params = dict(st["params"].named_parameters())
        opt_state, loss = _zoo_mesh_step(torch, module, loss_fn,
                                         st["params"], params, opt,
                                         st["opt_state"], batch, mesh, rules)
        st = {**st, "opt_state": opt_state, "step": st["step"] + 1}
        return st, float(loss), _state_fingerprint(torch, st)

    root = tempfile.mkdtemp(prefix="chip_smoke_zoo_ckpt_")
    try:
        torch.cuda.synchronize()
        saved = _state_fingerprint(torch, state)
        manager = CheckpointManager(root, "chip-smoke-zoo")
        t0 = time.perf_counter()
        handle = save_train_state(state, manager, mesh, tp_fsdp_rules())
        save_s = time.perf_counter() - t0
        check(handle is not None, "the save committed no checkpoint")
        on_disk = sum(f.stat().st_size for f in pathlib.Path(root).iterdir())
        print(f"ckpt: t5-base AdamW state after {int(state['step'])} steps "
              f"on the mesh saved: {len(handle.manifest['params'])} leaves, "
              f"{on_disk} bytes on disk in {save_s:.3f} s "
              f"({on_disk / save_s / 1e9:.3f} GB/s)")
        opt = optim.adamw(lambda c: torch.full((), ZOO_LR, device=DEVICE),
                          weight_decay=0.0)
        _, ref_loss, ref_print = step(state, tp_fsdp_rules(), opt)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        for rules_name, rules, seed, route in (
                ("tp_fsdp_rules()", tp_fsdp_rules(), 1, "load_for_rank"),
                ("rules all None (bench.py)", _all_rules(), 2,
                 "restore_on_mesh")):
            model, _, opt, opt_state = _zoo_mesh_state(torch, module, cfg,
                                                       mesh, rules, seed)
            fresh = {"params": model, "opt_state": opt_state,
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=DEVICE)}
            ckpt = latest_checkpoint(manager)
            got = restore_route(ckpt, fresh, mesh, rules)
            check(got == route, f"t5-base, {rules_name}: restore route "
                  f"{got}, expected {route}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh = restore_train_state(fresh, ckpt, mesh, rules)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(torch.equal(_state_fingerprint(torch, fresh), saved),
                  f"t5-base, {rules_name}: the restored state differs from "
                  f"the saved one")
            _, loss, prints = step(fresh, rules, opt)
            check(loss == ref_loss and torch.equal(prints, ref_print),
                  f"t5-base, {rules_name}: the resumed step's loss {loss} "
                  f"against the uninterrupted {ref_loss}")
            print(f"ckpt: t5-base, {rules_name}: restored by {route} in "
                  f"{restore_s:.3f} s ({on_disk / restore_s / 1e9:.3f} GB/s),"
                  f" the state equal to the saved one; the next step's loss "
                  f"{loss} and state bit-equal to the uninterrupted run's")
            del fresh, model, opt_state
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not os.path.exists(root), f"{root} was not deleted")


def _process_start_time():
    """This process's start on the wall clock, from /proc (None where it
    cannot be read)."""
    try:
        with open("/proc/stat") as f:
            boot = next(float(line.split()[1]) for line in f
                        if line.startswith("btime "))
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rpartition(")")[2].split()[19])
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return None


def _gang_loop(config):
    """Phase 5l's and 5n's train loop, run by the gang's worker: phase 5's
    recipe at ``config["lr"]`` (phase 5's 1e-4 unless given) from seed 0,
    or from the trainer's checkpoint, to ``config["steps"]``; a checkpoint
    after step ``config["save_at"]`` where one is given. Reports each
    step's loss, ms, wall-clock span and (K1, K2, K3) launches, counted in
    this process."""
    t_loop = time.time()
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.train import (CheckpointManager, restore_train_state,
                                     save_train_state)

    device = config["device"]
    if device == "cuda":
        # As phase 1 sets them in this script's process.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = gpt.config(config["preset"], **config["overrides"])
    opt = ts.memory_efficient_optimizer(
        learning_rate=config.get("lr", 1e-4))
    t0 = time.perf_counter()
    state = ts.init_train_state(cfg, optimizer=opt, seed=0, device=device)
    loaded, restore_s = session.get_checkpoint(), None
    if loaded is not None:
        t1 = time.perf_counter()
        state = restore_train_state(state, loaded)
        restore_s = time.perf_counter() - t1
    init_s = time.perf_counter() - t0
    step = ts.make_train_step(cfg, optimizer=opt)
    batch = _train_batch(torch, cfg, config["batch"], config["seq"], 0,
                         device)
    where = {"pid": os.getpid(), "t_loop": t_loop,
             "t_process": _process_start_time(), "init_s": init_s,
             "restore_s": restore_s,
             "device": str(next(state["params"].parameters()).device),
             "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
             "group": (dist.get_backend(), dist.get_world_size())
             if dist.is_initialized() else None,
             "master_port": os.environ.get("MASTER_PORT")}
    _zero_counts(fa)
    for i in range(int(state["step"]), config["steps"]):
        counts0 = _counts(fa)
        t_wall = time.time()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        ms = (time.perf_counter() - t0) * 1e3
        report = {"step": i + 1, "loss": loss, "ms": ms,
                  "span": (t_wall, time.time()),
                  "launches": [b - a for a, b in zip(counts0, _counts(fa))],
                  **where}
        ckpt = None
        if i + 1 == config.get("save_at"):
            t0 = time.perf_counter()
            ckpt = save_train_state(
                state, CheckpointManager(config["dir"], "chip-smoke-5l"),
                extra={"step": i + 1})
            report["save_s"] = time.perf_counter() - t0
        session.report(report, checkpoint=ckpt)


def phase_gang(torch, ref):
    """Phase 5's recipe through TorchTrainer.fit in one worker process on
    the card (``_gang_loop``): GANG_STEPS steps with a checkpoint after
    GANG_SAVE_AT, then a second fit resumed from it. Returns the worker's
    (K1, K2, K3) launches over both fits."""
    import ray_tpu_torch
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import TorchTrainer

    gc.collect()
    torch.cuda.empty_cache()
    print(f"gang: this process holds {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB of the card ({torch.cuda.memory_reserved() / 2**30:.2f} "
          f"GiB reserved) while the worker trains; {CARD}")
    cfg = gpt.config(TRAIN_PRESET, **TRAIN_OVERRIDES)
    per_layer = [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers]
    # The worker imports the port of this checkout.
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(HERE)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    root = tempfile.mkdtemp(prefix="chip_smoke_gang_")
    config = {"device": DEVICE, "preset": TRAIN_PRESET,
              "overrides": TRAIN_OVERRIDES, "batch": TRAIN_BATCH,
              "seq": TRAIN_SEQ, "save_at": GANG_SAVE_AT,
              "steps": GANG_STEPS, "dir": root}
    scaling = ScalingConfig(num_workers=1, use_gpu=DEVICE == "cuda",
                            runtime_env={"worker_process": True})

    def fit(checkpoint):
        t0 = time.time()
        result = TorchTrainer(_gang_loop, train_loop_config=config,
                              scaling_config=scaling,
                              resume_from_checkpoint=checkpoint).fit()
        return result, t0, time.time() - t0

    ray_tpu_torch.init(num_cpus=2)
    try:
        gpus = ray_tpu_torch.cluster_resources().get("GPU", 0)
        check(gpus == (torch.cuda.device_count() if DEVICE == "cuda" else 0),
              f"the runtime counts {gpus} GPUs")
        first, t_first, fit_first = fit(None)
        second, t_second, fit_second = fit(first.checkpoint)
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    check(not os.path.exists(root), f"{root} was not deleted")

    runs = [first.metrics_history, second.metrics_history]
    check([m["step"] for m in runs[0]] == list(range(1, GANG_STEPS + 1)),
          f"the first fit reported steps {[m['step'] for m in runs[0]]}")
    check([m["step"] for m in runs[1]]
          == list(range(GANG_SAVE_AT + 1, GANG_STEPS + 1)),
          f"the resumed fit reported steps {[m['step'] for m in runs[1]]}, "
          f"not {GANG_SAVE_AT + 1}-{GANG_STEPS} only")
    check(first.checkpoint is not None
          and first.checkpoint.extra_metadata.get("step") == GANG_SAVE_AT,
          f"the first fit's checkpoint is {first.checkpoint}")
    for run, label in ((runs[0], "first fit"), (runs[1], "resumed fit")):
        losses = [m["loss"] for m in run]
        want = ref["losses"][run[0]["step"] - 1:run[-1]["step"]]
        check(losses == want, f"5l {label}: losses {losses} are not phase "
              f"5's {want} bit for bit")
        check(all(m["launches"] == per_layer for m in run),
              f"5l {label}: launches per step (K1, K2, K3) "
              f"{[m['launches'] for m in run]}, expected {per_layer}")
        w = run[0]
        check(w["pid"] != os.getpid(), f"5l {label} ran in this process")
        if DEVICE == "cuda":
            check(w["device"] == "cuda:0" and w["visible"] == "0",
                  f"5l {label}: the worker trained on {w['device']} with "
                  f"CUDA_VISIBLE_DEVICES {w['visible']!r}")
        check(w["group"] == ("nccl" if DEVICE == "cuda" else "gloo", 1)
              and w["master_port"] is not None
              and w["master_port"] != os.environ.get("MASTER_PORT"),
              f"5l {label}: the worker's group is {w['group']} on port "
              f"{w['master_port']}")
    counts = tuple(sum(m["launches"][k] for run in runs for m in run)
                   for k in range(3))
    gang_ms = [m["ms"] for m in runs[0]]
    timed = gang_ms[TRAIN_WARMUP:]
    plain = ref["step_ms"][TRAIN_WARMUP:GANG_STEPS]
    print(f"gang: {TRAIN_PRESET} through TorchTrainer.fit in worker pid "
          f"{runs[0][0]['pid']} (this process {os.getpid()}) on "
          f"{runs[0][0]['device']}, CUDA_VISIBLE_DEVICES "
          f"{runs[0][0]['visible']!r} from its lease, its own "
          f"{runs[0][0]['group']} group on port {runs[0][0]['master_port']}; "
          f"{CARD}")
    print(f"gang: losses {[m['loss'] for m in runs[0]]} and resumed "
          f"{[m['loss'] for m in runs[1]]}, bit-equal to phase 5's steps")
    print(f"gang: ms per step {[round(t, 2) for t in gang_ms]}; steps "
          f"{TRAIN_WARMUP + 1}-{GANG_STEPS} mean "
          f"{statistics.mean(timed):.2f} ms with the gang against "
          f"{statistics.mean(plain):.2f} ms for phase 5's same steps "
          f"({[round(t, 2) for t in plain]}) without it; {CARD}")
    for run, t0, fit_s, label in ((runs[0], t_first, fit_first, "first"),
                                  (runs[1], t_second, fit_second,
                                   "resumed")):
        w = run[0]
        extra = (f", save {run[GANG_SAVE_AT - 1]['save_s']:.2f} s"
                 if label == "first" else
                 f", of which restore {w['restore_s']:.2f} s")
        started = ("not read" if w["t_process"] is None
                   else f"{w['t_process'] - t0:.2f} s")
        print(f"gang: {label} fit {fit_s:.2f} s: the worker process "
              f"started {started} after fit() (to the second: /proc), its "
              f"loop began {w['t_loop'] - t0:.2f} s after it (imports, "
              f"actor, process group), its state was initialised in "
              f"{w['init_s']:.2f} s{extra}; {CARD}")
    print(f"gang: launches in the worker (K1, K2, K3) {tuple(counts)} over "
          f"{len(runs[0]) + len(runs[1])} steps = {tuple(per_layer)} per "
          f"step")
    return counts


# -- 5m. the training side of AIR ----------------------------------------------

def _worker_imports_this_checkout():
    """Worker processes import the port of this checkout."""
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(HERE)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])


def _air_logit_stats(model, batch):
    """Per sequence of ``batch["tokens"]``: the fp64 sum and the max abs of
    ``model``'s logits. The predictor's apply_fn, and the worker's probe
    of its own model."""
    logits = model(batch["tokens"])
    return {"logit_sum": logits.double().sum(dim=(1, 2)),
            "logit_max_abs": logits.float().abs().amax(dim=(1, 2))}


def _air_model(device):
    """An untrained gpt-410m of 5m's recipe on ``device``: what the
    predictor restores its checkpoint into."""
    import torch

    from ray_tpu_torch.models import gpt
    cfg = gpt.config(AIR_PRESET, **AIR_OVERRIDES)
    return gpt.init(cfg, torch.Generator(device).manual_seed(1), device)


def _air_probe(seed):
    """AIR_PROBE_ROWS sequences of tokens from ``seed``."""
    from ray_tpu_torch.models import gpt
    vocab = gpt.config(AIR_PRESET).vocab_size
    return np.random.default_rng(seed).integers(
        0, vocab, (AIR_PROBE_ROWS, AIR_SEQ), dtype=np.int32)


def phase_air_example(torch):
    """5m(a): the port's GPT-J example through its main() at gpt-410m,
    one worker process on the card with its own 1-rank group. Returns the
    worker's (K1, K2, K3) launches and the losses."""
    from ray_tpu_torch.examples import gptj_finetune
    from ray_tpu_torch.models import gpt

    cfg = gpt.config(AIR_PRESET, **AIR_OVERRIDES)
    per_step = [cfg.n_layers] * 3 if DEVICE == "cuda" else [0, 0, 0]
    argv = ["--preset", AIR_PRESET, "--num-workers", "1", "--dp", "1",
            "--fsdp", "1", "--tp", "1", "--steps", str(AIR_STEPS)]
    if DEVICE != "cuda":
        argv += ["--cpu", "--batch", str(AIR_BATCH), "--seq", str(AIR_SEQ)]
    _worker_imports_this_checkout()
    t0 = time.perf_counter()
    result = gptj_finetune.main(argv)
    fit_s = time.perf_counter() - t0
    hist = result.metrics_history
    check([m["step"] for m in hist] == list(range(AIR_STEPS)),
          f"5m(a): the example reported steps {[m['step'] for m in hist]}")
    check(all(m["kernel_launches"] == per_step for m in hist),
          f"5m(a): launches per step (K1, K2, K3) "
          f"{[m['kernel_launches'] for m in hist]}, expected {per_step}")
    losses = [m["loss"] for m in hist]
    check(np.isfinite(losses).all(), f"5m(a): losses {losses}")
    check(DEVICE != "cuda" or all("approx_mfu" in m for m in hist),
          "5m(a): the example reported no approx_mfu on the card")
    ms = [AIR_BATCH * AIR_SEQ / m["tokens_per_s"] * 1e3 for m in hist]
    tokens_s = [m["tokens_per_s"] for m in hist]
    mfu = [m.get("approx_mfu") for m in hist]
    print(f"air example: {AIR_PRESET} ({hist[0]['n_params'] / 1e9:.3f} B "
          f"params) through ray_tpu_torch.examples.gptj_finetune.main("
          f"{argv}) in {fit_s:.1f} s; losses {losses}; ms per step "
          f"{[round(t, 2) for t in ms]}, tokens/s "
          f"{[round(t, 1) for t in tokens_s]}, approx_mfu {mfu} of the "
          f"989 TFLOP/s bf16 peak; steps 3-{AIR_STEPS} mean "
          f"{statistics.mean(ms[2:]):.2f} ms; launches (K1, K2, K3) "
          f"{per_step} per step; {CARD}")
    return tuple(sum(m["kernel_launches"][k] for m in hist)
                 for k in range(3)), losses


def _air_loop(config):
    """5m(b)'s train loop, run by the gang's worker: the example's recipe
    on prepare_mesh's 1-rank mesh from seed 0, or from the trainer's
    checkpoint by restore_train_state; each step's batch from the rank's
    shard of the "train" dataset (iter_torch_batches); a sharded report
    (session.report_sharded) after each step of ``config["save_at"]``,
    a plain one after the others. Reports each step's loss, ms, (K1, K2,
    K3) launches and the process's peak RSS, the last step the probe's
    logit stats."""
    import resource

    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import MeshConfig
    from ray_tpu_torch.parallel.mesh import registered_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.parallel.train_step import (default_optimizer,
                                                   init_train_state,
                                                   make_train_step)
    from ray_tpu_torch.train import prepare_mesh, restore_train_state

    def rss_gib():
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20

    device = config["device"]
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = prepare_mesh(MeshConfig(dp=1, fsdp=1, tp=1), device=device)
    cfg = gpt.config(config["preset"], **config["overrides"])
    rules = ShardingRules(sequence=None)
    opt = default_optimizer(learning_rate=config["lr"],
                            total_steps=config["steps"])
    state = init_train_state(cfg, mesh, rules, opt, seed=0, device=device)
    loaded, restore_s = session.get_checkpoint(), None
    if loaded is not None:
        t0 = time.perf_counter()
        state = restore_train_state(state, loaded, mesh, rules)
        restore_s = time.perf_counter() - t0
    step = make_train_step(cfg, mesh, rules, opt)
    start = int(state["step"])
    shard = session.get_dataset_shard("train")
    where = {"pid": os.getpid(), "restore_s": restore_s,
             "device": str(next(state["params"].parameters()).device),
             "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
    save_s = None
    for i, b in enumerate(shard.iter_torch_batches(
            batch_size=config["batch"], device=device)):
        if i == config["steps"]:
            break
        if i < start:
            continue
        batch = {"tokens": b["tokens"][:, :-1], "targets": b["tokens"][:, 1:]}
        counts0 = _counts(fa)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        report = {"step": i + 1, "loss": loss,
                  "ms": (time.perf_counter() - t0) * 1e3,
                  "launches": [b - a for a, b in zip(counts0, _counts(fa))],
                  "dtype": str(b["tokens"].dtype), "rss_gib": rss_gib(),
                  "prev_save_s": save_s, **where}
        if i + 1 == config["steps"]:
            probe = {"tokens": torch.tensor(config["probe"], device=device)}
            with torch.no_grad():
                report["probe"] = {k: v.cpu().numpy() for k, v in
                                   _air_logit_stats(state["params"],
                                                    probe).items()}
        save_s = None
        if i + 1 in config["save_at"]:
            t0 = time.perf_counter()
            with registered_mesh(mesh, rules):
                session.report_sharded(report, state,
                                       extra={"step": i + 1})
            save_s = time.perf_counter() - t0
        else:
            session.report(report)


def phase_air_training(torch, example_losses):
    """5m(b) with 5m(d)'s Data: _air_loop through TorchTrainer in one
    worker process on the card: fit 1 takes AIR_STEPS steps and reports a
    sharded checkpoint after each of AIR_SAVE_AT, which the trainer's
    executor commits; fit 2 resumes from the first of them and must
    repeat fit 1's later steps bit for bit. Fit 1 is 5m(a)'s recipe on
    5m(a)'s token stream (seed 0, drawn in the same order), so its losses
    must be 5m(a)'s bit for bit. Returns (the (K1, K2, K3)
    launches of both fits, fit 1's final ShardedCheckpoint and its last
    report, the storage directory to delete)."""
    import ray_tpu_torch
    from ray_tpu_torch import data
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import ShardedCheckpoint, TorchTrainer
    from ray_tpu_torch.train._internal import sharded_checkpoint as sc

    cfg = gpt.config(AIR_PRESET, **AIR_OVERRIDES)
    per_step = [cfg.n_layers] * 3 if DEVICE == "cuda" else [0, 0, 0]
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (AIR_STEPS * AIR_BATCH, AIR_SEQ + 1))
    root = tempfile.mkdtemp(prefix="chip_smoke_air_")
    config = {"device": DEVICE, "preset": AIR_PRESET,
              "overrides": AIR_OVERRIDES, "batch": AIR_BATCH, "lr": AIR_LR,
              "steps": AIR_STEPS, "save_at": AIR_SAVE_AT,
              "probe": _air_probe(1)}
    scaling = ScalingConfig(num_workers=1, use_gpu=DEVICE == "cuda",
                            runtime_env={"worker_process": True})

    def fit(name, checkpoint):
        t0 = time.perf_counter()
        result = TorchTrainer(
            _air_loop, train_loop_config=config, scaling_config=scaling,
            datasets={"train": data.from_numpy(tokens, column="tokens")},
            run_config=RunConfig(name=name, storage_path=root),
            resume_from_checkpoint=checkpoint).fit()
        return result, time.perf_counter() - t0

    first, fit_first = fit("air", None)
    final = first.checkpoint
    check(isinstance(final, ShardedCheckpoint)
          and final.extra == {"step": AIR_SAVE_AT[-1]}
          and final.world_size == 1,
          f"5m(b): fit 1's checkpoint is {final}")
    at = ShardedCheckpoint.from_manifest_uri(final.uri.replace(
        sc.manifest_filename("air", final.seq),
        sc.manifest_filename("air", final.seq - 1)))
    check(at.extra == {"step": AIR_SAVE_AT[0]},
          f"5m(b): fit 1's first commit holds {at.extra}")
    config = {**config, "save_at": ()}  # no check reads fit 2's save
    second, fit_second = fit("air-resumed", at)

    runs = [first.metrics_history, second.metrics_history]
    check([m["step"] for m in runs[0]] == list(range(1, AIR_STEPS + 1)),
          f"5m(b): fit 1 reported steps {[m['step'] for m in runs[0]]}")
    check([m["step"] for m in runs[1]]
          == list(range(AIR_SAVE_AT[0] + 1, AIR_STEPS + 1)),
          f"5m(b): fit 2 reported steps {[m['step'] for m in runs[1]]}")
    fed = [m["loss"] for m in runs[0]]
    check(fed == example_losses, f"5m(d): fit 1's losses {fed} from "
          f"iter_torch_batches are not 5m(a)'s {example_losses} bit for bit")
    resumed = [m["loss"] for m in runs[1]]
    want = [m["loss"] for m in runs[0][AIR_SAVE_AT[0]:]]
    check(resumed == want, f"5m(b): resumed losses {resumed} are not fit "
          f"1's {want} bit for bit")
    for run in runs:
        check(np.isfinite([m["loss"] for m in run]).all(),
              f"5m(b): losses {[m['loss'] for m in run]}")
        check(all(m["launches"] == per_step for m in run),
              f"5m(b): launches per step (K1, K2, K3) "
              f"{[m['launches'] for m in run]}, expected {per_step}")
        check(all(m["dtype"] == "torch.int32" for m in run),
              f"5m(d): batches of {[m['dtype'] for m in run]}")
        w = run[0]
        check(w["pid"] != os.getpid(), "5m(b) ran in this process")
        if DEVICE == "cuda":
            check(w["device"] == "cuda:0" and w["visible"] == "0",
                  f"5m(b): the worker trained on {w['device']} with "
                  f"CUDA_VISIBLE_DEVICES {w['visible']!r}")
    for a, b in zip(runs[0][-1]["probe"].values(),
                    runs[1][-1]["probe"].values()):
        check(np.array_equal(a, b), "5m(b): the resumed model's probe "
              "logits differ from fit 1's")
    manifest = final.manifest
    check(manifest["world_size"] == 1 and len(manifest["shards"]) == 1,
          f"5m(b): the manifest lists {len(manifest['shards'])} shards of "
          f"world {manifest['world_size']}")
    state_bytes = manifest["shards"][0]["bytes"]
    ms = [m["ms"] for m in runs[0]]
    print(f"air training: {AIR_PRESET} through TorchTrainer.fit in worker "
          f"pid {runs[0][0]['pid']} on {runs[0][0]['device']}, batches from "
          f"iter_torch_batches of the rank's Data shard (int32); fit 1 "
          f"{fit_first:.1f} s, losses {fed} (5m(a)'s bit for bit), ms "
          f"per step {[round(t, 2) for t in ms]}; fit 2 from the step-"
          f"{AIR_SAVE_AT[0]} commit {fit_second:.1f} s, losses {resumed}, "
          f"bit-equal to fit 1's; {CARD}")
    print(f"air training: report_sharded wrote {state_bytes / 1e9:.3f} GB "
          f"(fp32 params and AdamW moments) in one shard, committed by the "
          f"trainer's executor; the save after step {AIR_SAVE_AT[0]} took "
          f"{runs[0][AIR_SAVE_AT[0]]['prev_save_s']:.2f} s in the loop "
          f"(layout, write, commit); restore {runs[1][0]['restore_s']:.2f} "
          f"s; the worker's peak RSS {runs[0][0]['rss_gib']:.2f} GiB after "
          f"step 1, {runs[0][-1]['rss_gib']:.2f} GiB after step "
          f"{AIR_STEPS}; {CARD}")
    counts = tuple(sum(m["launches"][k] for run in runs for m in run)
                   for k in range(3))
    return counts, final, runs[0][-1], root


def phase_air_predictor(torch, final, last):
    """5m(c) and 5m(d)'s BatchPredictor: TorchPredictor from fit 1's final
    ShardedCheckpoint in this process on the card, then BatchPredictor
    mapping it over a Dataset of 2 x AIR_PROBE_ROWS sequences. Returns
    the K1 launches."""
    from ray_tpu_torch import data
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.train import BatchPredictor, TorchPredictor

    probes = [_air_probe(1), _air_probe(2)]
    _zero_counts(fa)
    t0 = time.perf_counter()
    pred = TorchPredictor.from_checkpoint(final, model=_air_model,
                                          apply_fn=_air_logit_stats,
                                          device=DEVICE)
    load_s = time.perf_counter() - t0
    got = pred.predict({"tokens": probes[0]})
    want = last["probe"]
    for k in want:
        check(got[k].dtype == want[k].dtype
              and np.array_equal(got[k], want[k]),
              f"5m(c): the predictor's {k} {got[k]!r} is not the worker's "
              f"{want[k]!r} bit for bit")
    other = pred.predict({"tokens": probes[1]})
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = BatchPredictor.from_checkpoint(
        final, TorchPredictor, model=_air_model, apply_fn=_air_logit_stats,
        device=DEVICE).predict(
            data.from_numpy(np.concatenate(probes), column="tokens"),
            batch_size=AIR_PROBE_ROWS, min_scoring_workers=1,
            max_scoring_workers=1)
    rows = list(out.iter_batches(batch_size=None))
    batch_s = time.perf_counter() - t0
    for k in want:
        col = np.concatenate([r[k] for r in rows])
        check(np.array_equal(col, np.concatenate([got[k], other[k]])),
              f"5m(d): BatchPredictor's {k} differ from the predictor's")
    gc.collect()
    torch.cuda.empty_cache()
    counts = _counts(fa)
    print(f"air predictor: TorchPredictor.from_checkpoint (restore "
          f"{load_s:.2f} s) on {DEVICE}: per-sequence fp64 logit sums "
          f"{got['logit_sum'].tolist()} and max abs "
          f"{got['logit_max_abs'].tolist()}, bit-equal to the worker's after "
          f"step {AIR_STEPS}; BatchPredictor over {2 * AIR_PROBE_ROWS} "
          f"sequences in {batch_s:.2f} s, bit-equal to the predictor's; "
          f"K1 launches {counts[0]}; {CARD}")
    return counts


class _AirCollective:
    """5m(e)'s rank: an actor on half of the card."""

    def setup(self, world, rank):
        from ray_tpu_torch.util import collective
        collective.init_collective_group(world, rank, "nccl", "air")
        self.rank = rank
        return True

    def run(self, n):
        import torch

        from ray_tpu_torch.util import collective
        x = torch.tensor(np.random.default_rng(self.rank).normal(size=n),
                         device=DEVICE)
        reduced = collective.allreduce(x, "air")
        gathered = collective.allgather(x, "air")
        half = collective.allreduce(x.to(torch.bfloat16), "air")
        return {"device": str(x.device),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "pid": os.getpid(), "reduced": reduced,
                "gathered": gathered, "bf16": half}


def phase_air_collective(torch):
    """5m(e): two worker-process actors, each on a 0.5 GPU lease of the
    one card, allreduce (star and ring path) and allgather float64 CUDA
    tensors; values against numpy's, dtypes against the JAX package's
    (the star path reduces float64 as float32, the ring keeps float64).
    A bfloat16 tensor, which numpy lacks, is reduced as its float32
    values."""
    import ray_tpu_torch
    from ray_tpu_torch.util import collective

    actor = ray_tpu_torch.remote(_AirCollective).options(
        num_gpus=0.5 if DEVICE == "cuda" else 0,
        runtime_env={"worker_process": True})
    ranks = [actor.remote() for _ in range(2)]
    ray_tpu_torch.get([a.setup.remote(2, r) for r, a in enumerate(ranks)])
    for n in AIR_COLLECTIVE_SIZES:
        outs = ray_tpu_torch.get([a.run.remote(n) for a in ranks])
        xs = [np.random.default_rng(r).normal(size=n) for r in range(2)]
        ring = 8 * n > collective._INLINE_LIMIT
        want = (xs[0] + xs[1] if ring
                else xs[0].astype(np.float32) + xs[1].astype(np.float32))
        for o in outs:
            check(o["device"] == ("cuda:0" if DEVICE == "cuda" else "cpu"),
                  f"5m(e): a rank's tensor is on {o['device']}")
            check(o["reduced"].dtype == want.dtype
                  and np.array_equal(o["reduced"], want),
                  f"5m(e): allreduce of {n} float64 gave "
                  f"{o['reduced'].dtype}, expected {want.dtype} and numpy's "
                  f"values")
            check(all(np.array_equal(g, x) and g.dtype == np.float64
                      for g, x in zip(o["gathered"], xs)),
                  f"5m(e): allgather of {n} float64 differs from the ranks'"
                  f" arrays")
            halves = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                      for x in xs]
            check(o["bf16"].dtype == np.float32
                  and np.array_equal(o["bf16"], halves[0] + halves[1]),
                  f"5m(e): allreduce of {n} bfloat16 gave {o['bf16'].dtype},"
                  f" expected float32 and the sum of their float32 values")
        check(len({o["pid"] for o in outs} | {os.getpid()}) == 3,
              "5m(e): the ranks share a process")
        if DEVICE == "cuda":
            check(all(o["visible"] == "0" for o in outs),
                  f"5m(e): CUDA_VISIBLE_DEVICES {[o['visible'] for o in outs]}")
        print(f"air collective: allreduce and allgather of {n} float64 "
              f"({8 * n} bytes) on {outs[0]['device']} between two worker "
              f"processes on 0.5 GPU leases of card "
              f"{outs[0]['visible']!r}: {'ring' if ring else 'star'} path, "
              f"reduced to {outs[0]['reduced'].dtype} (the JAX package's "
              f"dtype), values numpy's; bfloat16 reduced to "
              f"{outs[0]['bf16'].dtype}")
    for a in ranks:
        ray_tpu_torch.kill(a)


def phase_air(torch):
    """Phase 5m: 5m(a)-(e) on one runtime; returns the (K1, K2, K3)
    launches of 5m's paths (the workers' and this process's)."""
    import ray_tpu_torch

    gc.collect()
    torch.cuda.empty_cache()
    _worker_imports_this_checkout()
    ray_tpu_torch.init(num_cpus=4)
    root = None
    try:
        example, losses = _timed("5m(a)", phase_air_example, torch)
        training, final, last, root = _timed(
            "5m(b)", phase_air_training, torch, losses)
        predictor = _timed("5m(c)", phase_air_predictor, torch, final, last)
        _timed("5m(e)", phase_air_collective, torch)
    finally:
        ray_tpu_torch.shutdown()
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)
    check(root is None or not os.path.exists(root), f"{root} was not deleted")
    return tuple(a + b + c for a, b, c in zip(example, training, predictor))


# -- 5n. Tune over TorchTrainer ---------------------------------------------

def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def phase_tune(torch, ref):
    """Two gpt-1.3b trials of phase 5's recipe under a Tuner, both on the
    card at once, each in a worker process on TUNE_GPUS of it: (a) both
    on card 0 with overlapping steps; (b) the phase-5-lr trial's losses
    phase 5's bit for bit, the other's first loss phase 5's first; (c)
    Tune's stop after TUNE_STOP iterations, no errors, the best result the
    lower final loss; (d) after fit() no worker process remains, the card
    is free in the runtime and its memory back. Returns the workers'
    (K1, K2, K3) launches."""
    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import TorchTrainer

    cfg = gpt.config(TRAIN_PRESET, **TRAIN_OVERRIDES)
    per_layer = [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers]
    on_card = DEVICE == "cuda"
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    _worker_imports_this_checkout()
    config = {"device": DEVICE, "preset": TRAIN_PRESET,
              "overrides": TRAIN_OVERRIDES, "batch": TRAIN_BATCH,
              "seq": TRAIN_SEQ, "steps": GANG_STEPS}
    scaling = ScalingConfig(
        num_workers=1, use_gpu=on_card,
        resources_per_worker={"GPU": TUNE_GPUS} if on_card else None,
        runtime_env={"worker_process": True})
    ray_tpu_torch.init(num_cpus=4)
    try:
        t0 = time.time()
        results = tune.Tuner(
            TorchTrainer(_gang_loop, train_loop_config=config,
                         scaling_config=scaling),
            param_space={"lr": tune.grid_search(list(TUNE_LRS))},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        max_concurrent_trials=2),
            run_config=RunConfig(stop={"training_iteration": TUNE_STOP}),
        ).fit()
        fit_s = time.time() - t0
        gpus = (ray_tpu_torch.available_resources().get("GPU", 0),
                ray_tpu_torch.cluster_resources().get("GPU", 0))
    finally:
        ray_tpu_torch.shutdown()

    # (c) Tune's stop criterion ended both trials, and the best trial.
    check(not results.errors, f"5n: trials failed: {results.errors}")
    trials = sorted(results, key=lambda r: -r.config["lr"])
    check([r.config["lr"] for r in trials] == list(TUNE_LRS),
          f"5n: trials of lr {[r.config['lr'] for r in trials]}")
    runs = [r.metrics_history for r in trials]
    for r, run in zip(trials, runs):
        check(r.metrics["training_iteration"] == TUNE_STOP
              and [m["step"] for m in run] == list(range(1, TUNE_STOP + 1)),
              f"5n (c): the lr {r.config['lr']} trial ended at iteration "
              f"{r.metrics['training_iteration']} after steps "
              f"{[m['step'] for m in run]}, not at {TUNE_STOP}")
    best = results.get_best_result()
    check(best.metrics["loss"] == min(r.metrics["loss"] for r in trials),
          f"5n (c): the best result's loss {best.metrics['loss']} is not "
          f"the lower of {[r.metrics['loss'] for r in trials]}")
    # (b) losses against phase 5's.
    losses = [[m["loss"] for m in run] for run in runs]
    check(losses[0] == ref["losses"][:TUNE_STOP],
          f"5n (b): the lr {TUNE_LRS[0]} trial's losses {losses[0]} are "
          f"not phase 5's {ref['losses'][:TUNE_STOP]} bit for bit")
    check(losses[1][0] == ref["losses"][0],
          f"5n (b): the lr {TUNE_LRS[1]} trial's first loss "
          f"{losses[1][0]} is not phase 5's {ref['losses'][0]}")
    check(all(m["launches"] == per_layer for run in runs for m in run),
          f"5n: launches per step (K1, K2, K3) "
          f"{[[m['launches'] for m in run] for run in runs]}, expected "
          f"{per_layer}")
    # (a) both trials' workers on card 0 at once.
    workers = [run[0] for run in runs]
    check(workers[0]["pid"] != workers[1]["pid"]
          and os.getpid() not in (workers[0]["pid"], workers[1]["pid"]),
          f"5n (a): the trials ran in pids "
          f"{[w['pid'] for w in workers]} (this process {os.getpid()})")
    if on_card:
        check(all(w["device"] == "cuda:0" and w["visible"] == "0"
                  for w in workers),
              f"5n (a): the workers trained on "
              f"{[(w['device'], w['visible']) for w in workers]}")
    spans = [(run[0]["span"][0], run[-1]["span"][1]) for run in runs]
    overlap = min(e for _, e in spans) - max(b for b, _ in spans)
    check(overlap > 0, f"5n (a): the trials' step windows {spans} do not "
          f"overlap")
    # (d) nothing left behind.
    gone = [w["pid"] for w in workers if not _alive(w["pid"])]
    check(len(gone) == 2, f"5n (d): worker processes "
          f"{[w['pid'] for w in workers if _alive(w['pid'])]} outlived "
          f"fit()")
    check(gpus[0] == gpus[1], f"5n (d): {gpus[0]} of {gpus[1]} GPUs "
          f"available after fit()")
    deadline = time.monotonic() + 60
    while torch.cuda.mem_get_info()[0] < free0 - TUNE_FREE_SLACK \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    free1 = torch.cuda.mem_get_info()[0]
    check(free1 >= free0 - TUNE_FREE_SLACK,
          f"5n (d): {free1 / 2**30:.2f} GiB free after fit() against "
          f"{free0 / 2**30:.2f} GiB before 5n")

    counts = tuple(sum(m["launches"][k] for run in runs for m in run)
                   for k in range(3))
    print(f"tune: {TRAIN_PRESET} under a Tuner over TorchTrainer, lr "
          f"{list(TUNE_LRS)}, 2 trials at once, each a worker process on "
          f"{TUNE_GPUS} GPU (pids {[w['pid'] for w in workers]}, "
          f"CUDA_VISIBLE_DEVICES {[w['visible'] for w in workers]}, "
          f"{[w['device'] for w in workers]}); fit() {fit_s:.1f} s; "
          f"steps overlapping for {overlap:.2f} s; {CARD}")
    for r, run in zip(trials, runs):
        w = run[0]
        print(f"tune: lr {r.config['lr']}: loop began {w['t_loop'] - t0:.2f}"
              f" s after fit(), state in {w['init_s']:.2f} s; losses "
              f"{[m['loss'] for m in run]}; ms per step "
              f"{[round(m['ms'], 2) for m in run]}; launches (K1, K2, K3) "
              f"{tuple(sum(m['launches'][k] for m in run) for k in range(3))}"
              f"; {CARD}")
    print(f"tune: (b) the lr {TUNE_LRS[0]} trial's losses bit-equal to "
          f"phase 5's steps 1-{TUNE_STOP}; (c) best lr "
          f"{best.config['lr']}; (d) both worker processes gone, "
          f"{gpus[0]} of {gpus[1]} GPUs available, free card memory "
          f"{free1 / 2**30:.2f} GiB ({free0 / 2**30:.2f} GiB before 5n)")
    print(f"tune: launches in the workers (K1, K2, K3) {counts} over "
          f"{sum(len(run) for run in runs)} steps = {tuple(per_layer)} per "
          f"step; phase 5's same steps {[round(t, 2) for t in ref['step_ms'][:TUNE_STOP]]} ms")
    return counts


# -- 5o. RLlib's learner on the card ------------------------------------------

def _rllib_batch(n, seed):
    """A GAE-complete CartPole-shaped batch of ``n`` rows from ``seed``."""
    from ray_tpu_torch.rllib import SampleBatch
    rng = np.random.default_rng(seed)
    return SampleBatch({
        SampleBatch.OBS: rng.normal(size=(n, 4)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, 2, n),
        SampleBatch.ACTION_LOGP: rng.normal(-0.7, 0.05, n).astype(
            np.float32),
        SampleBatch.ADVANTAGES: rng.normal(1.0, 3.0, n).astype(np.float32),
        SampleBatch.VALUE_TARGETS: rng.normal(size=n).astype(np.float32)})


def _rllib_spaces():
    """CartPole's spaces as the port reads them, without gymnasium."""
    return (types.SimpleNamespace(shape=(4,)),
            types.SimpleNamespace(n=2, shape=()))


class _CartPole:
    """gymnasium's CartPole-v1 (its dynamics, rewards, termination and
    500-step limit) in numpy, with the spaces read by their attributes:
    5o's environment where gymnasium is not installed."""

    def __init__(self, _config=None):
        self.observation_space, self.action_space = _rllib_spaces()
        self._rng = np.random.default_rng()
        self._state = np.zeros(4)
        self._steps = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, 4)
        self._steps = 0
        return self._state.astype(np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self._state
        force = 10.0 if int(action) == 1 else -10.0
        cos, sin = np.cos(theta), np.sin(theta)
        temp = (force + 0.05 * theta_dot ** 2 * sin) / 1.1
        theta_acc = (9.8 * sin - cos * temp) / (
            0.5 * (4.0 / 3.0 - 0.1 * cos ** 2 / 1.1))
        x_acc = temp - 0.05 * theta_acc * cos / 1.1
        self._state = np.array([x + 0.02 * x_dot, x_dot + 0.02 * x_acc,
                                theta + 0.02 * theta_dot,
                                theta_dot + 0.02 * theta_acc])
        self._steps += 1
        terminated = bool(abs(self._state[0]) > 2.4
                          or abs(self._state[2]) > 12 * 2 * np.pi / 360)
        return (self._state.astype(np.float32), 1.0, terminated,
                self._steps >= 500, {})


class _Pendulum:
    """gymnasium's Pendulum-v1 (its dynamics, reward, reset and 200-step
    limit, in its arithmetic) in numpy, with the spaces read by their
    attributes: 5p's environment where gymnasium is not installed."""

    def __init__(self, _config=None):
        high = np.array([1.0, 1.0, 8.0], dtype=np.float32)
        self.observation_space = types.SimpleNamespace(
            shape=(3,), low=-high, high=high, dtype=np.float32)
        self.action_space = types.SimpleNamespace(
            shape=(1,), low=np.full(1, -2.0, np.float32),
            high=np.full(1, 2.0, np.float32), dtype=np.float32)
        self._rng = np.random.default_rng()
        self._state = np.zeros(2)
        self._steps = 0

    def _obs(self):
        theta, thetadot = self._state
        return np.array([np.cos(theta), np.sin(theta), thetadot],
                        dtype=np.float32)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        high = np.array([np.pi, 1.0])
        self._state = self._rng.uniform(low=-high, high=high)
        self._steps = 0
        return self._obs(), {}

    def step(self, u):
        th, thdot = self._state
        u = np.clip(u, -2.0, 2.0)[0]
        costs = ((th + np.pi) % (2 * np.pi) - np.pi) ** 2 + \
            0.1 * thdot ** 2 + 0.001 * (u ** 2)
        newthdot = thdot + (3 * 10.0 / (2 * 1.0) * np.sin(th)
                            + 3.0 / (1.0 * 1.0 ** 2) * u) * 0.05
        newthdot = np.clip(newthdot, -8, 8)
        self._state = np.array([th + newthdot * 0.05, newthdot])
        self._steps += 1
        return self._obs(), -costs, False, self._steps >= 200, {}


def _rllib_sgd(torch, device, backend):
    """One ``PPO._sgd`` of the cartpole-ppo recipe on the policy of seed 7
    on ``device``; returns the weights, metrics and seconds."""
    from ray_tpu_torch.rllib import PPOConfig, SampleBatch, TorchPolicy
    from ray_tpu_torch.rllib.algorithms import ppo

    obs_space, act_space = _rllib_spaces()
    policy = TorchPolicy(4, act_space, (64, 64), seed=7, obs_space=obs_space,
                         device=device)
    cfg = PPOConfig().training(
        lr=RLLIB_LR, num_sgd_iter=RLLIB_SGD_ITERS,
        sgd_minibatch_size=RLLIB_MINIBATCH, learner_backend=backend)
    update, state = ppo.PPO._build_update(None, policy, cfg)
    batch = _rllib_batch(RLLIB_BATCH, 3)
    t0 = time.perf_counter()
    _, metrics = ppo.PPO._sgd(types.SimpleNamespace(iteration=1), policy,
                              update, state, SampleBatch(dict(batch)), cfg)
    seconds = time.perf_counter() - t0
    on = {t.device.type for t in _leaves(policy.params)}
    return policy.get_weights(), metrics, seconds, on


def _leaves(tree):
    from ray_tpu_torch.rllib.policy.torch_policy import named_leaves
    return list(named_leaves(tree).values())


def _max_diff(a, b):
    return max(float(np.max(np.abs(x - y)))
               for x, y in zip(_leaves(a), _leaves(b)))


def phase_rllib(torch):
    """PPO's learner on the card, on both routes: one _sgd on the card
    against the CPU on both schedules; two remote learners sharing the
    card against the local one; the tuned cartpole-ppo trained
    RLLIB_ITERS iterations with its learner on the card (gymnasium's
    CartPole-v1, or _CartPole where gymnasium is not installed), saved
    and restored. With gymnasium, also the multi-agent example's main()."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib import (LearnerConfig, LearnerGroup,
                                     MLPActorCriticModule, PPOLearner,
                                     RLModuleSpec)
    from ray_tpu_torch.rllib.core.learner_group import learner_options
    gymnasium = _gymnasium()
    route = ("no gymnasium (CartPole-v1's dynamics in numpy)"
             if gymnasium is None else
             f"gymnasium {gymnasium.__version__} (its CartPole-v1)")
    print(f"rllib: route: {route}")

    # One _sgd on the card and on the CPU, both schedules.
    for backend in (None, "fused"):
        t = {}
        for device in (DEVICE, "cpu"):
            t[device] = _rllib_sgd(torch, device, backend)
        (w_card, m_card, s_card, on_card), (w_cpu, m_cpu, s_cpu, _) = \
            t[DEVICE], t["cpu"]
        diff = _max_diff(w_card, w_cpu)
        schedule = "per minibatch" if backend is None else "fused"
        check(on_card == {torch.device(DEVICE).type},
              f"5o: the {schedule} learner's parameters are on {on_card}")
        check(diff <= RLLIB_SGD_TOL,
              f"5o: _sgd ({schedule}) on {DEVICE} against the CPU: the "
              f"weights differ by {diff:.3e} > {RLLIB_SGD_TOL}")
        gap = max(abs(m_card[k] - m_cpu[k]) for k in m_cpu)
        check(set(m_card) == set(m_cpu) and gap <= RLLIB_SGD_TOL,
              f"5o: _sgd ({schedule}) metrics {m_card} against {m_cpu}")
        print(f"rllib: _sgd {schedule} ({RLLIB_SGD_ITERS} epochs of "
              f"{RLLIB_BATCH} rows in minibatches of {RLLIB_MINIBATCH}): "
              f"{s_card:.3f} s on {DEVICE}, {s_cpu:.3f} s on the CPU; "
              f"weights within {diff:.3e}, metrics within {gap:.3e} of the "
              f"CPU's (bound {RLLIB_SGD_TOL}); {CARD}")

    # Remote learners sharing the card against the local learner.
    obs_space, act_space = _rllib_spaces()
    spec = RLModuleSpec(MLPActorCriticModule, obs_space, act_space,
                        {"fcnet_hiddens": (64, 64)})
    config = LearnerConfig(lr=RLLIB_LR, seed=7, device=DEVICE)
    batch = {"obs": np.asarray(_rllib_batch(512, 5)["obs"]),
             "actions": np.random.default_rng(6).integers(0, 2, 512),
             "logp_old": np.full(512, -0.69, np.float32),
             "advantages": np.random.default_rng(7).normal(
                 size=512).astype(np.float32),
             "value_targets": np.random.default_rng(8).normal(
                 size=512).astype(np.float32)}
    local = PPOLearner(spec, config).build()
    check(all(t.device.type == torch.device(DEVICE).type
              for t in _leaves(local.params)),
          "5o: the local learner's parameters are not on the card")
    ray_tpu_torch.init(num_cpus=4)
    try:
        share = learner_options(DEVICE, RLLIB_REMOTE_LEARNERS)
        group = LearnerGroup(PPOLearner, spec, config,
                             num_remote_learners=RLLIB_REMOTE_LEARNERS)
        held = ray_tpu_torch.available_resources().get("GPU", 0)
        remote_g, remote_m = ray_tpu_torch.get(
            group._learners[0].compute_gradients.remote(batch))
        local_g, local_m = local.compute_gradients(batch)
        g_diff = _max_diff(remote_g, local_g)
        group.update(batch)
        local.update(batch)
        w_diff = _max_diff(group.get_weights(), local.get_weights())
        group.stop()
        total = ray_tpu_torch.cluster_resources().get("GPU", 0)
    finally:
        ray_tpu_torch.shutdown()
    check(DEVICE != "cuda" or (
        share == {"num_gpus": RLLIB_LEARNER_SHARE}
        and held == total - RLLIB_REMOTE_LEARNERS * RLLIB_LEARNER_SHARE),
          f"5o: {RLLIB_REMOTE_LEARNERS} remote learners on {share}: "
          f"{held} of {total} GPUs available while they lived")
    check(g_diff <= RLLIB_SGD_TOL and remote_m.keys() == local_m.keys(),
          f"5o: the remote learner's gradients differ by {g_diff:.3e}")
    check(w_diff <= RLLIB_SGD_TOL,
          f"5o: after one update the group's weights differ by {w_diff:.3e}")
    print(f"rllib: LearnerGroup(PPOLearner, num_remote_learners="
          f"{RLLIB_REMOTE_LEARNERS}) leasing {share} each ({held} of "
          f"{total} GPUs free while they lived): gradients within "
          f"{g_diff:.3e} of the local learner's on {DEVICE}, weights after "
          f"one update within {w_diff:.3e}")

    from ray_tpu_torch.rllib import PPOConfig
    env = "CartPole-v1" if gymnasium is not None else _CartPole

    def cartpole(workers):
        return (PPOConfig().environment(env)
                .rollouts(num_rollout_workers=workers)
                .training(lr=RLLIB_LR, train_batch_size=RLLIB_BATCH,
                          num_sgd_iter=RLLIB_SGD_ITERS,
                          sgd_minibatch_size=RLLIB_MINIBATCH)
                .resources(device=DEVICE).debugging(seed=7))

    ray_tpu_torch.init(num_cpus=8)
    try:
        algo = cartpole(2).build()
        check(all(t.device.type == torch.device(DEVICE).type
                  for t in _leaves(algo.local_policy.params)),
              "5o: the PPO learner's policy is not on the card")
        t0 = time.perf_counter()
        results = [algo.train() for _ in range(RLLIB_ITERS)]
        train_s = time.perf_counter() - t0
        rewards = [r["episode_reward_mean"] for r in results]
        first, last = rewards[0], rewards[-1]
        check(np.isfinite(last) and last > 45 and last > 2.5 * first,
              f"5o: cartpole-ppo did not learn: rewards {rewards}")
        path = algo.save(tempfile.mkdtemp(prefix="chip_smoke_rllib_"))
        obs = np.random.default_rng(0).normal(size=(8, 4)).astype(
            np.float32)
        greedy = [algo.compute_single_action(o) for o in obs]
        algo2 = cartpole(1).build()
        algo2.restore(path)
        shutil.rmtree(path, ignore_errors=True)
        check(algo2.iteration == RLLIB_ITERS
              and _max_diff(algo2.get_weights(), algo.get_weights()) == 0
              and [algo2.compute_single_action(o) for o in obs] == greedy,
              "5o: the restored algorithm differs from the saved one")
        algo.stop()
        algo2.stop()
    finally:
        ray_tpu_torch.shutdown()
    print(f"rllib: cartpole-ppo ({route}), the learner on {DEVICE}: "
          f"{RLLIB_ITERS} iterations in {train_s:.1f} s "
          f"({[round(r['time_this_iter_s'], 2) for r in results]} s each); "
          f"episode_reward_mean {[round(x, 1) for x in rewards]} (bar: "
          f"last > 45 and > 2.5 x first); saved and restored, the same "
          f"weights and greedy actions; {CARD}")

    if gymnasium is None:
        return
    from ray_tpu_torch.examples import multi_agent_ppo
    ray_tpu_torch.init(num_cpus=8)
    try:
        t0 = time.perf_counter()
        res, actions = multi_agent_ppo.main([] if DEVICE == "cuda"
                                            else ["--cpu"])
        example_s = time.perf_counter() - t0
    finally:
        ray_tpu_torch.shutdown()
    check(actions == {"p0": 1, "p1": 0} and np.isfinite(
        [res["p0/total_loss"], res["p1/total_loss"]]).all(),
        f"5o: the multi-agent example's greedy actions {actions}")
    print(f"rllib: the multi-agent example's main() on {DEVICE} in "
          f"{example_s:.1f} s: joint reward {res['episode_reward_mean']:.1f}"
          f"/20, greedy actions {actions}")


# -- 5p. RLlib's other learners on the card -----------------------------------

def _rllib_rows(n, seed, kind):
    """``n`` seeded transitions shaped as CartPole's or Pendulum's, with
    the rollout workers' columns (GAE fields and returns included):
    episodes of 5-60 steps, ended by a termination or a truncation."""
    from ray_tpu_torch.rllib import SampleBatch
    rng = np.random.default_rng(seed)
    ends = rng.random(n) < 0.05
    term = ends & (rng.random(n) < 0.7)
    obs_dim = 4 if kind == "cartpole" else 3
    cols = {
        SampleBatch.OBS: rng.normal(size=(n, obs_dim)),
        SampleBatch.NEXT_OBS: rng.normal(size=(n, obs_dim)),
        SampleBatch.ACTIONS: (rng.integers(0, 2, n) if kind == "cartpole"
                              else rng.uniform(-2, 2, (n, 1))),
        SampleBatch.REWARDS: rng.normal(size=n),
        SampleBatch.TERMINATEDS: term * 1.0,
        SampleBatch.TRUNCATEDS: (ends & ~term) * 1.0,
        SampleBatch.EPS_ID: np.cumsum(ends),
        SampleBatch.ACTION_LOGP: rng.normal(-0.7, 0.1, n),
        SampleBatch.VF_PREDS: rng.normal(size=n),
        SampleBatch.ADVANTAGES: rng.normal(1.0, 2.0, n),
        SampleBatch.VALUE_TARGETS: rng.normal(size=n),
        "returns": rng.normal(size=n)}
    return SampleBatch({k: v.astype(np.float32) if v.dtype == np.float64
                        else v for k, v in cols.items()})


def _rllib_learners(offline):
    """5p(a)'s learners: name -> (a fresh config; ``data(algo, i)``, the
    i-th update's batch and noise, drawn on the host (from the CPU
    learner's replay buffer for the replay learners) and handed to both
    devices' learners; ``update(algo, data)``, one update, returning its
    metrics), and the configs of pendulum-sac and cartpole-dqn.
    ``offline`` has a directory of JSON rows of each environment
    ("pendulum", "cartpole")."""
    import torch

    from ray_tpu_torch import rllib

    cartpole = _CartPole if _gymnasium() is None else "CartPole-v1"
    pendulum = _Pendulum if _gymnasium() is None else "Pendulum-v1"
    sac_kw = dict(lr=3e-4, train_batch_size=256, tau=0.005,
                  num_steps_sampled_before_learning_starts=500,
                  num_train_batches_per_iteration=256,
                  model={"fcnet_hiddens": [256, 256]})

    def dqn():
        return (rllib.DQNConfig().environment(cartpole)
                .rollouts(num_rollout_workers=1, rollout_fragment_length=256)
                .training(lr=8e-4, train_batch_size=64,
                          num_steps_sampled_before_learning_starts=500,
                          num_train_batches_per_iteration=32,
                          target_network_update_freq=128,
                          epsilon_timesteps=3000, dueling=True,
                          double_q=True)
                .debugging(seed=5))

    def sac():
        return (rllib.SACConfig().environment(pendulum)
                .rollouts(num_rollout_workers=1, rollout_fragment_length=256)
                .training(**sac_kw).debugging(seed=2))

    def replay(batch):
        def data(algo, i):
            name = type(algo).__name__
            if getattr(algo.config, "prioritized_replay", False):
                mb = algo._buffer.sample(batch, beta=0.4)
            else:
                mb = algo._buffer.sample(batch)
            gen = torch.Generator().manual_seed(20 + i)
            if name == "DQN":
                return mb, None
            if name == "TD3":
                return mb, torch.randn((batch, 1), generator=gen)
            noise = {k: torch.randn((batch, 1), generator=gen)
                     for k in ("target", "actor")}
            if name == "CQL":
                n = algo.config.num_ood_actions
                noise["rand"] = torch.rand((n, batch, 1), generator=gen)
                for k in ("cur", "next"):
                    noise[k] = torch.randn((n, batch, 1), generator=gen)
            return mb, noise

        def update(algo, data):
            mb, noise = data
            if noise is None:  # DQN
                return {"loss": algo.learn_on_batch(mb)[0]}
            device = algo.local_policy.device
            noise = (noise.to(device) if isinstance(noise, torch.Tensor)
                     else {k: v.to(device) for k, v in noise.items()})
            out = algo.learn_on_batch(mb, noise)
            return {k: v for k, v in out.items() if k != "td"}
        return data, update

    def rows(n):
        def update(algo, batch):
            out = algo.learn_on_batch(
                type(batch)({k: np.array(v) for k, v in batch.items()}))
            if isinstance(out, tuple):  # MARWIL
                return dict(zip(("loss", "policy_loss", "vf_loss"), out))
            return out if isinstance(out, dict) else {"loss": out}
        return (lambda algo, i: _rllib_rows(n, 40 + i, "cartpole")), update

    def es_data(algo, i):
        rng = np.random.default_rng(50 + i)
        top = algo._noise.size - algo._theta.numel()
        return (rng.integers(0, top, 20),
                rng.normal(size=20).astype(np.float32),
                rng.normal(size=20).astype(np.float32))

    def es_update(algo, data):
        grad, _ = algo.learn_on_returns(*data)
        return {"grad_norm": float(np.linalg.norm(grad))}

    def on(cfg, env=cartpole, workers=2):
        return cfg.environment(env).rollouts(num_rollout_workers=workers)

    return {
        "dqn": (lambda: dqn().training(prioritized_replay=True, n_step=3),
                *replay(64)),
        "sac": (sac, *replay(256)),
        "cql": (lambda: rllib.CQLConfig().environment(pendulum)
                .training(**sac_kw).offline_data(input_=offline["pendulum"])
                .debugging(seed=2), *replay(256)),
        "td3": (lambda: on(rllib.TD3Config(), pendulum, 1).debugging(seed=3),
                *replay(256)),
        "a2c": (lambda: on(rllib.A2CConfig()).rollouts(
            rollout_fragment_length=64).training(
                lr=2e-3, train_batch_size=512).debugging(seed=11),
                *rows(512)),
        "pg": (lambda: on(rllib.PGConfig()).training(
            lr=4e-3, train_batch_size=1024).debugging(seed=11), *rows(1024)),
        "impala": (lambda: on(rllib.ImpalaConfig()).debugging(seed=2),
                   *rows(512)),
        "appo": (lambda: on(rllib.APPOConfig()).debugging(seed=13),
                 *rows(512)),
        "bc": (lambda: rllib.BCConfig().environment(cartpole).offline_data(
            input_=offline["cartpole"]).debugging(seed=9), *rows(256)),
        "marwil": (lambda: rllib.MARWILConfig().environment(cartpole)
                   .offline_data(input_=offline["cartpole"])
                   .debugging(seed=9), *rows(256)),
        "es": (lambda: on(rllib.ESConfig()).debugging(seed=5), es_data,
               es_update),
    }, dqn, sac


def _gymnasium():
    try:
        import gymnasium
    except ImportError:
        return None
    return gymnasium


def _rllib_update_pair(torch, make, data, update):
    """One learner of 5p(a) built on the CPU and on the card, the card's
    state the CPU's (learner_state); RLLIB_UPDATES updates of each on the
    same data (a replay learner's buffer filled with the same rows, a
    3-step transform of them for DQN). Returns (the largest difference of
    the states and of the metrics, each device's ms of its last update,
    where the card learner's parameters are)."""
    from ray_tpu_torch.rllib.algorithms.learner_state import (
        learner_state, load_learner_state)
    from ray_tpu_torch.rllib.utils.replay_buffers import n_step_transform
    algos = [make().resources(device=d).build() for d in ("cpu", DEVICE)]
    try:
        on = {t.device.type for t in _leaves(algos[1].local_policy.params)}
        name = type(algos[0]).__name__
        if name in ("SAC", "CQL"):
            with torch.no_grad():
                for t in _leaves(algos[0].local_policy.params["head"]):
                    t.mul_(RLLIB_HEAD_SCALE)
        if name in ("DQN", "SAC", "TD3"):
            kind = "cartpole" if name == "DQN" else "pendulum"
            fill = _rllib_rows(4096, 11, kind)
            if name == "DQN":
                fill = n_step_transform(fill, 3, algos[0].config.gamma)
            for algo in algos:
                algo._buffer.add(fill)
        load_learner_state(algos[1], learner_state(algos[0]))
        metrics, ms = [{}, {}], [0.0, 0.0]
        for i in range(RLLIB_UPDATES):
            args = data(algos[0], i)
            for k, algo in enumerate(algos):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics[k] = update(algo, args)
                torch.cuda.synchronize()
                ms[k] = (time.perf_counter() - t0) * 1e3
        states = [learner_state(a) for a in algos]
    finally:
        for algo in algos:
            algo.stop()
    diff = max(float(np.max(np.abs(np.asarray(a, np.float64)
                                   - np.asarray(b, np.float64))))
               for key in states[0]
               for a, b in zip(_leaves(states[1][key]),
                               _leaves(states[0][key])))
    check(set(metrics[0]) == set(metrics[1]), f"5p: the metrics {metrics}")
    gap = max(abs(float(metrics[1][k]) - float(metrics[0][k]))
              for k in metrics[0])
    return diff, gap, ms, on


def phase_rllib_learners(torch):
    """5p: (a) each learner's update on the card against the CPU; (b)
    pendulum-sac and cartpole-dqn trained with their learners on the
    card, cartpole-dqn saved and restored; (c) each update's ms and the
    seconds per iteration."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib import JsonWriter

    gym = _gymnasium()
    route = ("no gymnasium (_CartPole, _Pendulum)" if gym is None else
             f"gymnasium {gym.__version__}")
    print(f"rllib learners: route: {route}")
    # Offline JSON for CQL (Pendulum's rows) and for BC and MARWIL
    # (CartPole's), written by the port's JsonWriter.
    offline = {}
    for i, kind in enumerate(("pendulum", "cartpole")):
        offline[kind] = tempfile.mkdtemp(prefix=f"chip_smoke_{kind}_")
        writer = JsonWriter(offline[kind])
        writer.write(_rllib_rows(2048, 60 + i, kind))
        writer.close()
    ray_tpu_torch.init(num_cpus=8)
    try:
        learners, dqn, sac = _rllib_learners(offline)
        rows = []
        for name, (make, data, update) in learners.items():
            diff, gap, ms, on = _rllib_update_pair(torch, make, data,
                                                   update)
            check(on == {torch.device(DEVICE).type},
                  f"5p: {name}'s learner parameters are on {on}")
            check(diff <= RLLIB_SGD_TOL and gap <= RLLIB_SGD_TOL,
                  f"5p: {name} on {DEVICE} against the CPU: state within "
                  f"{diff:.3e}, metrics within {gap:.3e} (bound "
                  f"{RLLIB_SGD_TOL})")
            rows.append((name, ms, diff, gap))
        for path in offline.values():
            shutil.rmtree(path, ignore_errors=True)
        print(f"rllib learners: one update on {DEVICE} against the CPU from "
              f"the same state, batch and noise ({RLLIB_UPDATES} each; ms of "
              f"the last on the card, on the CPU; state and metrics within, "
              f"bound {RLLIB_SGD_TOL}; {CARD}):")
        for name, ms, diff, gap in rows:
            print(f"  {name:7s} {ms[1]:9.3f} ms on {DEVICE} {ms[0]:9.3f} ms "
                  f"on the CPU; state within {diff:.3e}, metrics within "
                  f"{gap:.3e}")

        algo = sac().resources(device=DEVICE).build()
        check(all(t.device.type == torch.device(DEVICE).type for t in
                  _leaves(algo.local_policy.params) + _leaves(
                      algo._q_params)),
              "5p: pendulum-sac's learner is not on the card")
        t0 = time.perf_counter()
        results = [algo.train() for _ in range(RLLIB_SAC_ITERS)]
        sac_s = time.perf_counter() - t0
        learned = [r for r in results if "critic_loss" in r]
        acts = np.stack([r["actions"] for r in algo._buffer._rows])
        greedy = np.stack([algo.compute_single_action(o) for o in
                           np.random.default_rng(1).normal(size=(8, 3))])
        algo.stop()
        check(len(learned) == RLLIB_SAC_ITERS - 1 and all(
            np.isfinite([r[k] for k in ("critic_loss", "actor_loss",
                                        "alpha_loss", "alpha")]).all()
            for r in learned),
              f"5p: pendulum-sac's losses {learned}")
        check(np.abs(acts).max() <= 2.0 and np.abs(greedy).max() <= 2.0,
              f"5p: pendulum-sac's actions reach {np.abs(acts).max()}")
        print(f"rllib learners: pendulum-sac ({route}), the learner on "
              f"{DEVICE}: {RLLIB_SAC_ITERS} iterations in {sac_s:.1f} s "
              f"({[round(r['time_this_iter_s'], 2) for r in results]} s "
              f"each; {len(learned)} x 256 updates), critic_loss "
              f"{[round(r['critic_loss'], 3) for r in learned]}, alpha "
              f"{[round(r['alpha'], 4) for r in learned]}, "
              f"episode_reward_mean "
              f"{[round(r['episode_reward_mean'], 1) for r in results]}; "
              f"{len(acts)} actions within +-2; {CARD}")

        def cartpole_dqn():
            return dqn().resources(device=DEVICE)

        algo = cartpole_dqn().build()
        t0 = time.perf_counter()
        results = [algo.train() for _ in range(RLLIB_DQN_ITERS)]
        dqn_s = time.perf_counter() - t0
        eps = [r["epsilon"] for r in results]
        losses = [r["loss"] for r in results if np.isfinite(r["loss"])]
        check(all(a > b for a, b in zip(eps, eps[1:])) and losses
              and results[-1]["gradient_steps_total"] == 32 * len(losses),
              f"5p: cartpole-dqn's epsilon {eps}, losses {losses}")
        path = algo.save(tempfile.mkdtemp(prefix="chip_smoke_rllib_dqn_"))
        obs = np.random.default_rng(2).normal(size=(8, 4)).astype(np.float32)
        greedy = [algo.compute_single_action(o) for o in obs]
        algo2 = cartpole_dqn().build()
        algo2.restore(path)
        shutil.rmtree(path, ignore_errors=True)
        check(algo2.iteration == RLLIB_DQN_ITERS
              and _max_diff(algo2.get_weights()["params"],
                            algo.get_weights()["params"]) == 0
              and [algo2.compute_single_action(o) for o in obs] == greedy,
              "5p: the restored cartpole-dqn differs from the saved one")
        algo.stop()
        algo2.stop()
        print(f"rllib learners: cartpole-dqn ({route}), the learner on "
              f"{DEVICE}: {RLLIB_DQN_ITERS} iterations in {dqn_s:.1f} s "
              f"({[round(r['time_this_iter_s'], 2) for r in results]} s "
              f"each), epsilon {[round(e, 3) for e in eps]}, loss "
              f"{[round(x, 4) for x in losses]}, episode_reward_mean "
              f"{[round(r['episode_reward_mean'], 1) for r in results]}; "
              f"saved and restored, the same weights and greedy actions "
              f"{greedy}; {CARD}")
    finally:
        ray_tpu_torch.shutdown()


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


def some_phases(groups):
    """Phases 1 and 2, then the groups of later phases named in
    ``groups``: "zoo" (5h, 5i on the 1-rank mesh, 5k), "air" (5m),
    "rllib" (5o, 5p). Each phase's seconds and checks as in the whole
    run; prints no result line."""
    torch, _ = phase_environment()
    _timed("2", phase_build)
    unknown = set(groups) - {"zoo", "air", "rllib"}
    check(not unknown, f"no phase group {sorted(unknown)}")
    try:
        if "zoo" in groups:
            from ray_tpu_torch.parallel import MeshConfig
            from ray_tpu_torch.train.torch import prepare_mesh
            mesh = prepare_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1, ep=1))
            zoo_ref = _timed("5h", phase_zoo_training, torch)
            _timed("5h (tiny)", phase_zoo_small, torch)
            zoo_ref = _timed("5i", phase_zoo_mesh, torch, mesh, zoo_ref)
            _timed("5k", phase_zoo_context_parallel, torch, mesh, zoo_ref)
        if "air" in groups:
            _timed("5m", phase_air, torch)
        if "rllib" in groups:
            _timed("5o", phase_rllib, torch)
            _timed("5p", phase_rllib_learners, torch)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def main():
    if sys.argv[1:2] == ["--kernel-times"] and len(sys.argv) == 3:
        return kernel_times(sys.argv[2])
    if sys.argv[1:2] == ["--phases"] and len(sys.argv) == 3:
        return some_phases(sys.argv[2].split(","))
    check(len(sys.argv) == 1,
          "usage: chip_smoke.py [--kernel-times ROOT | --phases GROUPS]")
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
    """Phases 2-5p; returns the kernels line's rows."""
    from ray_tpu_torch.parallel import MeshConfig
    from ray_tpu_torch.parallel.mesh import mesh_sizes
    from ray_tpu_torch.train.torch import prepare_mesh

    _timed("2", phase_build)
    k1 = _timed("3 (K1)", phase_kernel_check, torch)
    k2, k3 = _timed("3 (K2, K3)", phase_backward_check, torch)
    _timed("3b (lookups)", phase_lookups, torch)
    k1_serve, buf13, served = _timed("4", phase_serving, torch)
    _timed("4 (gpt-micro)", phase_small_reference, torch)
    _timed("4 (gpt-moe-tiny)", phase_moe_small, torch)
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
    k1_ckpt, k2_ckpt, k3_ckpt = _timed("5e", phase_checkpoint, torch, mesh)
    k1_sel, k2_sel, k3_sel = _timed("5j", phase_selective_training, torch,
                                    mesh)
    _timed("5 (gpt-micro)", phase_small_training, torch)
    (k1_moe, k2_moe, k3_moe), moe_ref = _timed("5f", phase_moe_training,
                                               torch)
    k1_moe_mesh, k2_moe_mesh, k3_moe_mesh = _timed(
        "5g", phase_moe_mesh, torch, mesh, moe_ref, buf13)
    del buf13, moe_ref
    k1_moe_serve = _timed("4d", phase_moe_serving, torch)
    k1_llama, k2_llama, k3_llama = _timed("5b", phase_llama_training, torch)
    _timed("5c", phase_llama_small, torch)
    _timed("4e", phase_diffusion_serving, torch)
    k1_deploy = _timed("4f", phase_deployment, torch, served)
    _timed("4g", phase_example, torch)
    _timed("4h", phase_cli)
    zoo_ref = _timed("5h", phase_zoo_training, torch)
    _timed("5h (tiny)", phase_zoo_small, torch)
    zoo_ref = _timed("5i", phase_zoo_mesh, torch, mesh, zoo_ref)
    _timed("5k", phase_zoo_context_parallel, torch, mesh, zoo_ref)
    del zoo_ref
    k1_gang, k2_gang, k3_gang = _timed("5l", phase_gang, torch, ref)
    k1_air, k2_air, k3_air = _timed("5m", phase_air, torch)
    k1_tune, k2_tune, k3_tune = _timed("5n", phase_tune, torch, ref)
    _timed("5o", phase_rllib, torch)
    _timed("5p", phase_rllib_learners, torch)
    src = "ray_tpu_torch/ops/csrc/"
    ref = "ray_tpu/ops/flash_attention.py:"
    return [
        {"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
         "replaces": ref + "37",
         "launches": (k1_serve + k1_llama_serve + k1_llama_mesh + k1_train
                      + k1_mesh + k1_ckpt + k1_sel + k1_llama + k1_moe_serve
                      + k1_moe + k1_moe_mesh + k1_gang + k1_air
                      + k1_deploy + k1_tune), **k1},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": src + "flash_bwd.cu", "replaces": ref + "88",
         "launches": (k2_train + k2_mesh + k2_ckpt + k2_sel + k2_llama
                      + k2_moe + k2_moe_mesh + k2_gang + k2_air + k2_tune),
         **k2},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": src + "flash_bwd.cu", "replaces": ref + "131",
         "launches": (k3_train + k3_mesh + k3_ckpt + k3_sel + k3_llama
                      + k3_moe + k3_moe_mesh + k3_gang + k3_air + k3_tune),
         **k3}]


if __name__ == "__main__":
    main()

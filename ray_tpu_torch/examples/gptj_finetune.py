"""GPT-J fine-tune through TorchTrainer — the port's north-star loop.

The counterpart of the JAX package's ``examples/gptj_finetune.py``: the
same train loop (``prepare_mesh``, ``init_train_state``,
``default_optimizer``, ``make_train_step`` on synthetic next-token data)
with the same presets and sizes, run by ``TorchTrainer`` on one worker
process per rank:

* ``--preset gpt-tiny`` (default): a smoke run; with ``--cpu`` on the CPU
  over gloo, anywhere.
* ``--preset gpt-410m``: the single-card recipe (the port's flash
  attention kernels, selective remat, chunked cross-entropy).
* ``--preset gptj-6b``: the real thing, over several cards.

Each step reports its loss, tokens/s and parameter count, the launches of
the port's attention kernels (K1 forward, K2/K3 backward; 0 on the CPU,
where their plain versions run) and, on the card, ``approx_mfu`` against
the H100's dense bf16 peak.

Run, from the root of the repository:
    python -m ray_tpu_torch.examples.gptj_finetune --steps 2 --cpu \\
        --dp 1 --fsdp 1 --tp 1
"""

from __future__ import annotations

import argparse
import time

# One H100 SXM's dense bf16 rate (NVIDIA's data sheet), at its 700 W limit.
H100_BF16_PEAK = 989e12
SIZES = {"gpt-tiny": (4, 128), "gpt-410m": (16, 1024),
         "gptj-6b": (32, 2048)}


def train_loop(config: dict) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import MeshConfig
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.parallel.train_step import (default_optimizer,
                                                   init_train_state,
                                                   make_train_step)
    from ray_tpu_torch.train import prepare_mesh

    device = config["device"]
    mesh = prepare_mesh(MeshConfig(**config["mesh"]), device=device)
    cfg = gpt.config(config["preset"], **config.get("overrides", {}))
    rules = ShardingRules(
        sequence="sp" if config["mesh"].get("sp", 1) > 1 else None)
    optimizer = default_optimizer(learning_rate=config["lr"],
                                  total_steps=config["steps"])
    state = init_train_state(cfg, mesh, rules, optimizer,
                             seed=config["seed"], device=device)
    step = make_train_step(cfg, mesh, rules, optimizer)
    dev = next(state["params"].parameters()).device

    # Synthetic next-token data; ray_tpu_torch.data's iter_torch_batches
    # feeds a real corpus (session.get_dataset_shard gives the rank's
    # shard).
    rng = np.random.default_rng(config["seed"] + session.get_world_rank())
    batch, seq = config["batch"], config["seq"]
    n_params = cfg.num_params()
    flops_per_token = gpt.flops_per_token(cfg)
    # The MFU estimate holds on the card only; the CPU run has none.
    peak = H100_BF16_PEAK if dev.type == "cuda" else None
    n_devices = dist.get_world_size()

    for i in range(config["steps"]):
        toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
        data = {"tokens": torch.tensor(toks[:, :-1], dtype=torch.int32,
                                       device=dev),
                "targets": torch.tensor(toks[:, 1:], dtype=torch.int32,
                                        device=dev)}
        launches = (fa.launches, fa.dq_launches, fa.dkv_launches)
        t0 = time.perf_counter()
        state, metrics = step(state, data)
        loss = float(metrics["loss"])  # full sync
        dt = time.perf_counter() - t0
        tokens_per_s = batch * seq / dt
        report = {
            "step": i,
            "loss": loss,
            "tokens_per_s": tokens_per_s,
            "n_params": n_params,
            "kernel_launches": [b - a for a, b in zip(
                launches, (fa.launches, fa.dq_launches, fa.dkv_launches))],
        }
        if peak is not None:
            report["approx_mfu"] = (tokens_per_s * flops_per_token
                                    / (peak * n_devices))
        session.report(report)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="gpt-tiny", choices=sorted(SIZES))
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--seq", type=int, default=None)
    parser.add_argument("--num-workers", type=int, default=1)
    parser.add_argument("--dp", type=int, default=2)
    parser.add_argument("--fsdp", type=int, default=2)
    parser.add_argument("--tp", type=int, default=2)
    parser.add_argument("--sp", type=int, default=1)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU over gloo, not on the cards")
    args = parser.parse_args(argv)

    import ray_tpu_torch
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import TorchTrainer

    ray_tpu_torch.init(ignore_reinit_error=True)
    batch, seq = SIZES[args.preset]
    overrides = {}
    if args.preset != "gpt-tiny":
        # The tuned single-card recipe scales up unchanged.
        overrides = dict(attn_impl="flash", remat_policy="selective",
                         loss_chunk=2048)
    trainer = TorchTrainer(
        train_loop,
        train_loop_config={
            "preset": args.preset,
            "overrides": overrides,
            "mesh": {"dp": args.dp, "fsdp": args.fsdp, "tp": args.tp,
                     "sp": args.sp},
            "steps": args.steps,
            "batch": args.batch or batch,
            "seq": args.seq or seq,
            "lr": args.lr,
            "seed": 0,
            "device": "cpu" if args.cpu else None,
        },
        # Every rank in a process of its own, which sees the card of its
        # lease and joins the gang's process group.
        scaling_config=ScalingConfig(
            num_workers=args.num_workers, use_gpu=not args.cpu,
            runtime_env={"worker_process": True}),
    )
    result = trainer.fit()
    print("final metrics:", result.metrics)
    return result


if __name__ == "__main__":
    main()

"""Where the zoo's first gradients on a 1-rank mesh leave the unsharded ones.

A one-off measurement, not a test. For each preset named on the command
line (chip_smoke.py's phase 5h batch and seeds: ``ddpm-cifar``,
``vit-b16``, ``bert-base``, ``t5-base``), the first step's gradients of
the same model and batch, taken:

- without a mesh by ``torch.autograd.grad`` (phase 5h's step), twice (the
  card's own run-to-run determinism), and by ``backward()``;
- on a 1-rank mesh from ``prepare_mesh`` under the phase-5i rules
  (``tp_fsdp_rules()``, the UNet ``dp_rules()``) and under the all-None
  rules (FSDP2 alone, no tensor split over ``tp``), by ``backward()``
  inside ``registered_mesh``.

Each pair prints the loss's bits, the count of tensors whose gradient
differs bitwise, and the tensors that differ most (max |d| and |d| over
the tensor's norm). Run from the repo root, on the card (TF32 off, as
chip_smoke.py sets it):

    python3 tests/measure_zoo_mesh_gap.py ddpm-cifar vit-b16 bert-base t5-base
"""

import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _grads_plain(module, cfg, make_batch, loss_fn, backward):
    model = module.init(cfg, torch.Generator(device=cs.DEVICE).manual_seed(0),
                        cs.DEVICE)
    batch = make_batch(torch.Generator(device=cs.DEVICE).manual_seed(1))
    params = dict(model.named_parameters())
    loss = loss_fn(model, *batch)
    if backward:
        loss.backward()
        grads = [p.grad for p in params.values()]
    else:
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    return float(loss.detach()), {n: None if g is None
                                  else g.detach().clone()
                                  for n, g in zip(params, grads)}


def _grads_mesh(module, cfg, make_batch, loss_fn, mesh, rules):
    from ray_tpu_torch.models._common import batch_blocks
    from ray_tpu_torch.parallel.mesh import registered_mesh
    from ray_tpu_torch.parallel.sharding import (average_replicated_grads,
                                                 local)
    model = module.init(cfg, torch.Generator(device=cs.DEVICE).manual_seed(0),
                        cs.DEVICE, mesh=mesh, rules=rules)
    batch = make_batch(torch.Generator(device=cs.DEVICE).manual_seed(1))
    params = dict(model.named_parameters())
    with registered_mesh(mesh, rules):
        loss = loss_fn(model, *batch)
        (loss * batch_blocks(module.batch_spec)).backward()
        average_replicated_grads(params.values(), module.batch_spec)
    return float(loss.detach()), {n: None if p.grad is None
                                  else local(p.grad).detach().clone()
                                  for n, p in params.items()}


def _compare(what, a, b, top=6):
    (la, ga), (lb, gb) = a, b
    rows = []
    for n in ga:
        x, y = ga[n], gb[n]
        if x is None or y is None:
            if (x is None) != (y is None):
                rows.append((float("inf"), n, "reached on one side only"))
            continue
        if torch.equal(x, y):
            continue
        d = (x.double() - y.double()).abs()
        norm = float(x.double().norm())
        rows.append((float(d.max()) / max(norm, 1e-30), n,
                     f"max|d| {float(d.max()):.3e}, |d|/|g| "
                     f"{float(d.norm()) / max(norm, 1e-30):.3e}, "
                     f"{int((d != 0).sum())} of {d.numel()} elements"))
    same = "equal" if la == lb else "differ"
    print(f"  {what}: loss {la!r} vs {lb!r} ({same}); {len(rows)} of "
          f"{len(ga)} gradients differ bitwise")
    for _, n, msg in sorted(rows, reverse=True)[:top]:
        print(f"    {n}: {msg}")


def main(argv):
    from ray_tpu_torch.parallel import MeshConfig, dp_rules, tp_fsdp_rules
    from ray_tpu_torch.train.torch import prepare_mesh

    names = argv
    mesh = prepare_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1, ep=1),
                        cs.DEVICE)
    if cs.DEVICE != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).stdout.strip())
    for preset, module, cfg, make_batch, loss_fn, _ in \
            cs._zoo_training_cases(torch):
        if preset not in names:
            continue
        rules = dp_rules() if preset == "ddpm-cifar" else tp_fsdp_rules()
        print(f"{preset}:")
        ag = _grads_plain(module, cfg, make_batch, loss_fn, False)
        _compare("autograd.grad twice", ag,
                 _grads_plain(module, cfg, make_batch, loss_fn, False))
        bw = _grads_plain(module, cfg, make_batch, loss_fn, True)
        _compare("autograd.grad against backward", ag, bw)
        _compare("backward against the mesh, 5i's rules", bw,
                 _grads_mesh(module, cfg, make_batch, loss_fn, mesh, rules))
        _compare("backward against the mesh, all-None rules", bw,
                 _grads_mesh(module, cfg, make_batch, loss_fn, mesh,
                             cs._all_rules()))
        if cs.DEVICE != "cpu":
            torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

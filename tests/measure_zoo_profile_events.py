"""One-off measurement on the card: how repeatable is a count of the kernels
one zoo training step launches, by each way of reading it?

Each of ``chip_smoke.py``'s four full-width zoo models (phase 5h's cases)
is placed on the 1-rank NCCL mesh under 5i's rules and under
``context_parallel_rules()`` (5k), takes 2 warm-up steps, and is then
profiled ``N`` times as ``chip_smoke._profile(..., stats=)`` profiles it:
two steps in one trace, the second inside the ``COUNTED_RUN`` range. Of
each profile it prints the second step's kernels (copies, fills and
annotations left out) read two ways:

* ``linked``: the kernels whose launching host event (their correlation
  id's) starts inside the range;
* ``window``: the kernels that ran on the device inside the range, by the
  trace's timestamps; and the gaps between the range's start and the
  nearest kernel on either side.

and, once per placement, the operators a step dispatches on the card
(a ``TorchDispatchMode`` count by name), twice. A line per placement says
whether each way gave one multiset of kernel names over all profiles and
whether it equals the other rules'.

From the repo root, on the card:
``python3 tests/measure_zoo_profile_events.py [N]`` (N defaults to 8;
~5 minutes).
"""

import collections
import gc
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def _kernels(prof, torch):
    """(linked, window, gap before, gap after) of one profile."""
    from torch.autograd import DeviceType
    raw = prof.profiler.kineto_results.events()
    span = next(e for e in raw if e.name() == cs.COUNTED_RUN
                and e.device_type() == DeviceType.CPU)
    lo, hi = span.start_ns(), span.start_ns() + span.duration_ns()

    def kernel(e):
        return (e.device_type() == DeviceType.CUDA
                and not e.is_user_annotation()
                and not e.name().startswith(("Memcpy", "Memset")))
    linked = collections.Counter(
        e.key for e in cs._counted_run(prof)
        for _ in range(e.count)
        if not e.key.startswith(("Memcpy", "Memset")))
    device = [e for e in raw if kernel(e)]
    window = collections.Counter(
        e.name() for e in device
        if lo <= e.start_ns() and e.start_ns() + e.duration_ns() <= hi)
    before = [lo - (e.start_ns() + e.duration_ns()) for e in device
              if e.start_ns() + e.duration_ns() <= lo]
    after = [e.start_ns() - lo for e in device if e.start_ns() >= lo]
    return (linked, window, min(before) if before else None,
            min(after) if after else None)


def _op_count(torch, step):
    """The operators one step dispatches, by name."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))
    with Count() as mode:
        step()
        torch.cuda.synchronize()
    return mode.ops


def _placement(torch, mesh, case, rules, runs):
    from torch.profiler import ProfilerActivity, profile, record_function
    preset, module, cfg, make_batch, loss_fn, _ = case
    model, params, opt, state = cs._zoo_mesh_state(torch, module, cfg, mesh,
                                                   rules, 0)
    batch = make_batch(torch.Generator(device=cs.DEVICE).manual_seed(1))
    box = [state]

    def step():
        box[0], _ = cs._zoo_mesh_step(torch, module, loss_fn, model, params,
                                      opt, box[0], batch, mesh, rules)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    out = {"linked": [], "window": [], "before": [], "after": []}
    for _ in range(runs):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
            with record_function(cs.COUNTED_RUN):
                step()
                torch.cuda.synchronize()
        linked, window, before, after = _kernels(prof, torch)
        for k, v in (("linked", linked), ("window", window),
                     ("before", before), ("after", after)):
            out[k].append(v)
    try:
        out["ops"] = [_op_count(torch, step) for _ in range(2)]
    except Exception as e:  # a measurement: report and go on
        out["ops"] = f"{type(e).__name__}: {e}"
    del model, params, opt, box, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _report(preset, name, out, other):
    for way in ("linked", "window"):
        counts = [sum(c.values()) for c in out[way]]
        first = out[way][0]
        same = all(c == first for c in out[way])
        top = max(max(c.values()) for c in out[way]) if first else 0
        line = (f"{preset} {name} {way}: {counts}; one multiset over all "
                f"profiles: {same}")
        if not same:
            for i, c in enumerate(out[way]):
                d = {k: (first[k], c[k]) for k in set(first) | set(c)
                     if first[k] != c[k]}
                if d:
                    line += f"\n    profile {i} against 0: {d}"
        if other is not None:
            line += (f"; equal to the other rules' first: "
                     f"{other[way][0] == first}")
        print(line + f" (largest count of one name {top})")
    print(f"{preset} {name} gap from the last earlier kernel's end to the "
          f"range's start (us): {[b / 1e3 for b in out['before']]}; from the "
          f"start to the first kernel in it: "
          f"{[a / 1e3 for a in out['after']]}")
    if isinstance(out["ops"], str):
        print(f"{preset} {name} ops: {out['ops']}")
    else:
        a, b = out["ops"]
        line = (f"{preset} {name} ops a step: {sum(a.values())}, "
                f"{sum(b.values())}; the same twice: {a == b}")
        if other is not None and not isinstance(other["ops"], str):
            line += f"; equal to the other rules': {a == other['ops'][0]}"
        print(line)


def main(runs):
    torch, _ = cs.phase_environment()
    from ray_tpu_torch.parallel import (MeshConfig, context_parallel_rules,
                                        dp_rules, tp_fsdp_rules)
    from ray_tpu_torch.train.torch import prepare_mesh
    mesh = prepare_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1, ep=1))
    try:
        for case in cs._zoo_training_cases(torch):
            preset = case[0]
            first = dp_rules() if preset == "ddpm-cifar" else tp_fsdp_rules()
            a = _placement(torch, mesh, case, first, runs)
            _report(preset, "5i's rules", a, None)
            b = _placement(torch, mesh, case, context_parallel_rules(), runs)
            _report(preset, "context_parallel_rules()", b, a)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)

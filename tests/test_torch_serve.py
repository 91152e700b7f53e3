"""The port's ContinuousBatcher against the JAX package's.

The engine behaviours of tests/test_serve_autoscale.py run against both
packages' engines. Then both engines serve gpt-micro (attn_impl="flash")
greedily through the same glue, from the same carried-over weights: a
fixed [num_slots, S] token buffer with per-slot lengths; prefill writes a
prompt into its slot; each step runs the model's forward over the whole
buffer and takes the argmax at each active slot's last position. (No KV
cache: with causal attention the positions past a slot's length do not
change the logits before it.)
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from ray_tpu import serve as jserve
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch import serve as tserve
from ray_tpu_torch._private import builtin_metrics
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.serve.continuous_batching import _as_py

ENGINES = {"jax": jserve.ContinuousBatcher,
           "torch": tserve.ContinuousBatcher}

# fp32 logits of gpt-micro, fed the same tokens: the bound of
# tests/test_torch_gpt.py (summation order only).
LOGIT_TOL = 1e-4


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


# -- engine behaviours, both packages ------------------------------------

def _counting_engine(Engine, num_slots=4, eos=None, **kw):
    """Toy decode: each step emits the slot's prompt, so tests can see
    which iterations a sequence took part in."""
    calls = []

    def prefill(state, slot, prompt):
        state = dict(state)
        state[slot] = prompt
        return state

    def step(state, active_mask):
        calls.append(tuple(active_mask))
        return state, [state.get(i, 0) for i in range(num_slots)]

    eng = Engine(state={}, prefill_fn=prefill, step_fn=step,
                 num_slots=num_slots, eos_token=eos, **kw)
    return eng, calls


def _completes_sequences(Engine):
    async def drive():
        eng, _ = _counting_engine(Engine)
        outs = await asyncio.gather(eng.submit(7, max_new_tokens=3),
                                    eng.submit(9, max_new_tokens=2))
        return outs, eng.stats()

    outs, stats = _run(drive())
    assert outs == [[7, 7, 7], [9, 9]]
    assert stats["completed"] == 2 and stats["active_slots"] == 0


def _admits_into_running_batch(Engine):
    async def drive():
        eng, calls = _counting_engine(Engine, num_slots=4)
        first = asyncio.ensure_future(eng.submit(1, max_new_tokens=50))
        while eng.stats()["iterations"] < 3:
            await asyncio.sleep(0.001)
        second = asyncio.ensure_future(eng.submit(2, max_new_tokens=5))
        out2 = await second
        out1 = await first
        return out1, out2, eng.stats(), calls

    out1, out2, st, calls = _run(drive())
    assert out2 == [2] * 5 and out1 == [1] * 50
    assert st["admitted_running"] >= 1
    assert any(sum(mask) == 2 for mask in calls)
    assert st["iterations"] >= 50


def _eos_frees_slot(Engine):
    EOS = -1

    def prefill(state, slot, prompt):
        state = dict(state)
        state[slot] = list(prompt)
        return state

    def step(state, active_mask):
        state = {k: list(v) for k, v in state.items()}
        return state, [state[i].pop(0) if state.get(i) else 0
                       for i in range(4)]

    async def drive():
        eng = Engine(state={}, prefill_fn=prefill, step_fn=step,
                     num_slots=4, eos_token=EOS, max_new_tokens=100)
        return await asyncio.gather(eng.submit([5, 6, EOS, 7, 8]),
                                    eng.submit([1, EOS]))

    assert _run(drive()) == [[5, 6], [1]]


def _queues_beyond_slots(Engine):
    async def drive():
        eng, _ = _counting_engine(Engine, num_slots=2)
        outs = await asyncio.gather(
            *[eng.submit(i + 1, max_new_tokens=2) for i in range(5)])
        return outs, eng.stats()

    outs, stats = _run(drive())
    assert outs == [[i + 1] * 2 for i in range(5)]
    assert stats["completed"] == 5 and stats["pending"] == 0


def _step_failure_fails_batch_only(Engine):
    boom = {"on": False}

    def step(state, active_mask):
        if boom["on"]:
            raise RuntimeError("step exploded")
        return state, [0, 0]

    async def drive():
        eng = Engine(state={}, prefill_fn=lambda s, slot, p: s,
                     step_fn=step, num_slots=2)
        ok = await eng.submit(None, max_new_tokens=2)
        boom["on"] = True
        with pytest.raises(RuntimeError, match="step exploded"):
            await eng.submit(None, max_new_tokens=2)
        boom["on"] = False
        ok2 = await eng.submit(None, max_new_tokens=1)
        return ok, ok2

    assert _run(drive()) == ([0, 0], [0])


BEHAVIOURS = {
    "completes_sequences": _completes_sequences,
    "admits_into_running_batch": _admits_into_running_batch,
    "eos_frees_slot": _eos_frees_slot,
    "queues_beyond_slots": _queues_beyond_slots,
    "step_failure_fails_batch_only": _step_failure_fails_batch_only,
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("behaviour", sorted(BEHAVIOURS))
def test_continuous_batcher_behaviour(behaviour, engine):
    BEHAVIOURS[behaviour](ENGINES[engine])


def test_as_py_turns_torch_scalars_into_python_numbers():
    tok = torch.tensor([3, 4])[1]
    assert _as_py(tok) == 4 and type(_as_py(tok)) is int
    assert _as_py(np.int64(5)) == 5 and _as_py(6) == 6


def test_torch_engine_metrics_and_stats_match_jax_engine():
    def drive(Engine):
        async def go():
            eng, _ = _counting_engine(Engine, num_slots=2)
            await asyncio.gather(*[eng.submit(i, max_new_tokens=3)
                                   for i in range(3)])
            return eng.stats()
        return _run(go())

    tstats, jstats = drive(tserve.ContinuousBatcher), drive(
        jserve.ContinuousBatcher)
    assert {k: v for k, v in tstats.items() if k != "name"} == \
        {k: v for k, v in jstats.items() if k != "name"}
    admitted = builtin_metrics.serve_decode_admitted().series()
    assert admitted[(tstats["name"], "fresh")] >= 2
    active = builtin_metrics.serve_decode_active_slots().series()
    assert active[(tstats["name"],)] == 0.0


# -- greedy GPT decode through both engines -------------------------------

NUM_SLOTS, SEQ = 2, 256
PROMPT_LENS = (5, 40, 17)
MAX_NEW = 4


def _jax_engine(params, cfg, record):
    fwd = jax.jit(lambda p, t: jgpt.forward(p, cfg, t))
    state = {"buf": np.zeros((NUM_SLOTS, SEQ), np.int32),
             "lens": [0] * NUM_SLOTS}

    def prefill(state, slot, prompt):
        state["buf"][slot] = 0
        state["buf"][slot, :len(prompt)] = prompt
        state["lens"][slot] = len(prompt)
        return state

    def step(state, active_mask):
        with jax.default_matmul_precision("highest"):
            logits = np.asarray(fwd(params, state["buf"]))
        record.append((state["buf"].copy(), logits))
        last = logits[np.arange(NUM_SLOTS),
                      [max(n - 1, 0) for n in state["lens"]]]
        nxt = last.argmax(-1)
        for slot, live in enumerate(active_mask):
            if live:
                state["buf"][slot, state["lens"][slot]] = nxt[slot]
                state["lens"][slot] += 1
        return state, nxt

    return jserve.ContinuousBatcher(state=state, prefill_fn=prefill,
                                    step_fn=step, num_slots=NUM_SLOTS)


def _torch_engine(model):
    state = {"buf": torch.zeros((NUM_SLOTS, SEQ), dtype=torch.long),
             "lens": [0] * NUM_SLOTS}

    def prefill(state, slot, prompt):
        state["buf"][slot] = 0
        state["buf"][slot, :len(prompt)] = torch.as_tensor(prompt)
        state["lens"][slot] = len(prompt)
        return state

    def step(state, active_mask):
        with torch.inference_mode():
            logits = model(state["buf"])
        last = logits[torch.arange(NUM_SLOTS),
                      [max(n - 1, 0) for n in state["lens"]]]
        nxt = last.argmax(-1)
        for slot, live in enumerate(active_mask):
            if live:
                state["buf"][slot, state["lens"][slot]] = nxt[slot]
                state["lens"][slot] += 1
        return state, nxt

    return tserve.ContinuousBatcher(state=state, prefill_fn=prefill,
                                    step_fn=step, num_slots=NUM_SLOTS)


def _serve(engine, prompts):
    """The first prompt decodes alone for a step; the others then join
    the running batch (the last one queues until a slot frees). The first
    needs MAX_NEW steps, so the second joins it with steps to spare."""
    async def drive():
        first = asyncio.ensure_future(
            engine.submit(prompts[0], max_new_tokens=MAX_NEW))
        while engine.stats()["iterations"] < 1:
            await asyncio.sleep(0.001)
        rest = [engine.submit(p, max_new_tokens=MAX_NEW)
                for p in prompts[1:]]
        return await asyncio.gather(first, *rest)
    return _run(drive()), engine.stats()


def test_gpt_micro_flash_decode_matches_jax_engine():
    jcfg = jgpt.config("gpt-micro", attn_impl="flash")
    params = jax.tree_util.tree_map(
        np.asarray, jgpt.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]

    record = []
    jouts, jstats = _serve(_jax_engine(params, jcfg, record), prompts)
    model = tgpt.from_jax_params(
        params, tgpt.config("gpt-micro", attn_impl="flash"), device="cpu")
    touts, tstats = _serve(_torch_engine(model), prompts)

    assert all(len(o) == MAX_NEW for o in jouts)
    assert all(type(t) is int for o in touts for t in o)
    assert touts == jouts
    assert jstats["iterations"] == len(record)
    assert tstats["admitted_running"] >= 1 and jstats["admitted_running"] >= 1

    before = tfa.launches
    for buf, ref in record:  # each JAX step's tokens, fed to the port
        with torch.inference_mode():
            logits = model(torch.from_numpy(buf).long())
        np.testing.assert_allclose(logits.numpy(), ref, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    assert tfa.launches == before

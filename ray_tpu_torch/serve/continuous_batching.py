"""Continuous (iteration-level) batching for autoregressive decode loops.

The port of ``ray_tpu/serve/continuous_batching.py``, with the same API,
metrics and stats (Orca, OSDI '22; vLLM's scheduler). An autoregressive
model decodes one token per iteration, so batching whole requests leaves
the batch ragged — a 10-token completion holds its slot while a
500-token neighbor finishes. :class:`ContinuousBatcher` instead admits
**new requests into a running decode batch at iteration boundaries**:
the batch shape stays fixed (``num_slots`` — one set of kernel shapes
for the torch step, so nothing is re-planned per batch), each slot
carries an independent sequence, finished sequences free their slot
mid-flight, and freed slots are refilled from the queue before the next
step.

The engine is deliberately model-agnostic: the caller owns an opaque
``state`` (on the card: token buffers or a KV cache as torch tensors)
and supplies two callables —

``prefill_fn(state, slot, prompt) -> state``
    Write ``prompt`` into slot ``slot`` (in-place writes into the
    fixed-shape buffers; pad the prompt to the buffer's prompt axis —
    the engine never inspects prompts).

``step_fn(state, active_mask) -> (state, tokens)``
    One decode iteration over ALL slots. ``active_mask`` is a
    ``num_slots``-length tuple of bools — inactive (padding) slots must
    be masked out of attention/sampling but stay in the batch, keeping
    the call shape fixed. ``tokens`` is indexable per slot (list, numpy
    array or torch tensor); inactive slots' tokens are ignored.

Per-sequence completion is engine-side: a sequence finishes when it
emits ``eos_token`` or reaches its ``max_new_tokens``. ``submit()`` is
the whole client API — it parks on an asyncio future, so a replica can
drive the engine from plain async handlers.

The decode step runs in a worker thread (``asyncio.to_thread``) so a
multi-ms torch step (kernel launches plus the host read of the sampled
tokens) never stalls the replica's event loop.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ray_tpu_torch._private import builtin_metrics

_engine_ids = itertools.count(1)


def _as_py(token: Any) -> Any:
    """Host-side view of a per-slot token (0-d torch tensor or numpy
    scalar → Python number)."""
    item = getattr(token, "item", None)
    return item() if callable(item) else token


class _Sequence:
    __slots__ = ("prompt", "max_new_tokens", "future", "tokens",
                 "admitted_at_iter", "t_submit")

    def __init__(self, prompt, max_new_tokens: int, future):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.future = future
        self.tokens: List[Any] = []
        self.admitted_at_iter: Optional[int] = None
        self.t_submit = time.monotonic()


class ContinuousBatcher:
    """Slot-based continuous batching over a fixed-shape decode step.

    ::

        engine = ContinuousBatcher(
            state=init_cache(num_slots=8),
            prefill_fn=prefill, step_fn=decode_step,
            num_slots=8, eos_token=EOS)
        tokens = await engine.submit(prompt, max_new_tokens=64)
    """

    def __init__(self, *, state: Any,
                 prefill_fn: Callable[[Any, int, Any], Any],
                 step_fn: Callable[[Any, Tuple[bool, ...]],
                                   Tuple[Any, Any]],
                 num_slots: int, eos_token: Any = None,
                 max_new_tokens: int = 128,
                 max_queued: Optional[int] = None,
                 name: Optional[str] = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self._state = state
        self._prefill = prefill_fn
        self._step = step_fn
        self._num_slots = num_slots
        self._eos = eos_token
        self._default_max_new = max_new_tokens
        self._max_queued = max_queued
        self._name = name or f"decode{next(_engine_ids)}"
        self._slots: List[Optional[_Sequence]] = [None] * num_slots
        self._pending: Deque[_Sequence] = deque()
        self._wake: Optional[asyncio.Event] = None
        self._loop_task: Optional[asyncio.Task] = None
        self._iteration = 0
        self._completed = 0
        self._admitted_running = 0  # joined a live batch mid-decode
        self._admitted_fresh = 0    # admitted while the loop was idle
        self._steps_with_admission = 0

    # -- client API ------------------------------------------------------

    async def submit(self, prompt: Any, *,
                     max_new_tokens: Optional[int] = None) -> List[Any]:
        """Queue one sequence; resolves to its generated tokens (EOS
        excluded) once it completes. Admission happens at the next
        iteration boundary — possibly into a batch that is already
        decoding other sequences."""
        if self._max_queued is not None and \
                len(self._pending) >= self._max_queued:
            raise RuntimeError(
                f"ContinuousBatcher {self._name!r} admission queue is "
                f"full ({self._max_queued} pending)")
        self._ensure_loop()
        seq = _Sequence(prompt,
                        max_new_tokens or self._default_max_new,
                        asyncio.get_event_loop().create_future())
        self._pending.append(seq)
        self._wake.set()
        return await seq.future

    def stats(self) -> Dict[str, Any]:
        active = sum(1 for s in self._slots if s is not None)
        return {
            "name": self._name,
            "num_slots": self._num_slots,
            "active_slots": active,
            "pending": len(self._pending),
            "iterations": self._iteration,
            "completed": self._completed,
            "admitted_running": self._admitted_running,
            "admitted_fresh": self._admitted_fresh,
            "steps_with_admission": self._steps_with_admission,
        }

    # -- decode loop -----------------------------------------------------

    def _ensure_loop(self) -> None:
        if self._wake is None:
            self._wake = asyncio.Event()
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_event_loop().create_task(
                self._decode_loop())

    def _admit(self) -> None:
        """Fill free slots from the queue — the iteration-boundary
        admission step. Prefill happens here, slot by slot, so a newly
        admitted sequence decodes its first token in the very next
        step."""
        was_running = any(s is not None for s in self._slots)
        admitted = 0
        for slot in range(self._num_slots):
            if self._slots[slot] is not None or not self._pending:
                continue
            seq = self._pending.popleft()
            try:
                self._state = self._prefill(self._state, slot, seq.prompt)
            except BaseException as exc:  # noqa: BLE001 - per-sequence
                if not seq.future.done():
                    seq.future.set_exception(exc)
                continue
            seq.admitted_at_iter = self._iteration
            self._slots[slot] = seq
            admitted += 1
            if was_running:
                self._admitted_running += 1
            else:
                self._admitted_fresh += 1
        if admitted and was_running:
            self._steps_with_admission += 1
        if admitted:
            builtin_metrics.serve_decode_admitted().inc(
                admitted, tags={"engine": self._name,
                                "kind": ("running" if was_running
                                         else "fresh")})

    def _finish(self, slot: int, *, error: Optional[BaseException] = None
                ) -> None:
        seq = self._slots[slot]
        self._slots[slot] = None
        if seq is None or seq.future.done():
            return
        if error is not None:
            seq.future.set_exception(error)
        else:
            self._completed += 1
            seq.future.set_result(seq.tokens)

    async def _decode_loop(self) -> None:
        while True:
            self._admit()
            active_mask = tuple(s is not None for s in self._slots)
            n_active = sum(active_mask)
            builtin_metrics.serve_decode_active_slots().set(
                n_active, tags={"engine": self._name})
            if not n_active:
                # Idle: park until a submit wakes us (no spin).
                self._wake.clear()
                await self._wake.wait()
                continue
            try:
                # The fixed-shape torch step runs off the event loop;
                # this task is its only state toucher.
                self._state, tokens = await asyncio.to_thread(
                    self._step, self._state, active_mask)
            except BaseException as exc:  # noqa: BLE001 - fail the batch
                for slot, live in enumerate(active_mask):
                    if live:
                        self._finish(slot, error=exc)
                continue
            self._iteration += 1
            for slot, live in enumerate(active_mask):
                if not live:
                    continue
                seq = self._slots[slot]
                tok = _as_py(tokens[slot])
                done = False
                if self._eos is not None and tok == self._eos:
                    done = True  # EOS excluded from the result
                else:
                    seq.tokens.append(tok)
                    done = len(seq.tokens) >= seq.max_new_tokens
                if done:
                    self._finish(slot)

"""WorkerGroup: the gang of train-worker actors.

Analog of the reference's train/_internal/worker_group.py:92 (WorkerGroup of
actors created inside the trainer's placement group). Each TrainWorker runs
the user's train loop on a side thread and streams results through its
session queue; the driver drains via ``get_next_result`` actor calls —
the same protocol as the reference's ``start_training``/``get_next_results``
(train/_internal/backend_executor.py:315,414).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private import chaos
from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.air.session import StopSession, _Session
from ray_tpu_torch.exceptions import ActorDiedError
from ray_tpu_torch.util.placement_group import (PlacementGroup, placement_group,
                                          remove_placement_group)


@ray_tpu_torch.remote
class TrainWorker:
    """One rank of the training gang.

    Chaos sites ``train.worker_kill`` / ``train.result_delay_ms`` /
    ``train.ping_delay_ms`` are evaluated at the top of the driver-facing
    RPCs: a fired kill makes this worker play dead (every subsequent
    call raises ActorDiedError — the same observable behavior as a real
    SIGKILLed rank), which the BackendExecutor classifies as a system
    failure and answers with a gang restart."""

    def __init__(self, world_rank: int, world_size: int):
        self.world_rank = world_rank
        self.world_size = world_size
        self.session: Optional[_Session] = None
        self.thread: Optional[threading.Thread] = None
        self.env: Dict[str, str] = {}
        self._chaos_dead = False

    def _chaos_gate(self, delay_site: str) -> None:
        if chaos.ACTIVE:
            chaos.maybe_inject(delay_site)
            try:
                chaos.maybe_inject("train.worker_kill")
            except chaos.ChaosKill:
                self._chaos_dead = True
        if self._chaos_dead:
            raise ActorDiedError(
                message=f"train worker rank {self.world_rank} is dead "
                        "(chaos kill)")

    def _mark_chaos_dead(self) -> None:
        self._chaos_dead = True

    def setup_env(self, env: Dict[str, str]) -> None:
        """Backend hook: set process env (e.g. jax.distributed coordinator)."""
        import os
        self.env.update(env)
        os.environ.update(env)

    def get_metadata(self) -> dict:
        import os
        import socket
        return {"rank": self.world_rank, "hostname": socket.gethostname(),
                "pid": os.getpid(), "gpu_ids": ray_tpu_torch.get_gpu_ids()}

    def torch_bind_store(self, world_size: int) -> int:
        """Rank 0's half of the rendezvous: the port its process group's
        store is bound on, before the other ranks are told it."""
        from ray_tpu_torch.train.torch import bind_store
        return bind_store(world_size)

    def torch_distributed_init(self) -> None:
        """The process group over NCCL when this rank holds a card, over
        gloo when it was asked for the CPU (no GPU in its lease)."""
        from ray_tpu_torch.train.torch import distributed_init_if_needed
        distributed_init_if_needed(
            None if ray_tpu_torch.get_gpu_ids() else "cpu")

    def ping(self) -> bool:
        """Liveness probe for the executor's hang detector: cheap, and
        subject to the same chaos gate as the result path, so a
        chaos-killed or chaos-hung worker fails its probe the way a
        SIGKILLed one would."""
        self._chaos_gate("train.ping_delay_ms")
        return True

    def start_training(self, train_fn: Callable, config: dict,
                       trial_info: dict,
                       checkpoint=None, dataset_shards: Optional[dict] = None,
                       ckpt_ctx: Optional[dict] = None
                       ) -> None:
        self._chaos_gate("train.start_delay_ms")
        self.session = _Session(
            world_rank=self.world_rank,
            world_size=self.world_size,
            local_rank=self.world_rank,  # single-node: local == world
            trial_id=trial_info.get("trial_id", ""),
            trial_name=trial_info.get("trial_name", ""),
            config=config,
            checkpoint=checkpoint,
            dataset_shards=dataset_shards,
            ckpt_ctx=ckpt_ctx,
        )
        # A chaos kill fired mid-shard-write takes the whole rank down:
        # the session flags the actor dead, so every later RPC raises
        # ActorDiedError — the same observable behavior as a real
        # SIGKILL landing between a shard write and its ack.
        self.session.on_chaos_kill = self._mark_chaos_dead
        sess = self.session
        # The actor's runtime_env env_vars are APPLIED around this
        # method call only — but the train loop runs in a thread that
        # outlives it and reads env (e.g. RAY_TPU_JAX_PLATFORM in
        # distributed_init_if_needed). Snapshot now, re-assert in the
        # thread: losing this race left multi-controller workers
        # initializing jax on the wrong platform/device count, where
        # the first cross-process collective deadlocks.
        import os
        env_snapshot = dict(os.environ)

        def _run():
            for k, v in env_snapshot.items():
                if os.environ.get(k) != v:
                    os.environ[k] = v
            air_session._set_session(sess)
            try:
                try:
                    result = train_fn(config) if _wants_config(train_fn) \
                        else train_fn()
                    sess.result_queue.put(
                        {"finished": True, "result": result})
                except StopSession:
                    sess.result_queue.put({"finished": True, "stopped": True})
                except BaseException as e:  # noqa: BLE001
                    import traceback
                    sess.result_queue.put({
                        "finished": True, "error": e,
                        "traceback": traceback.format_exc()})
            finally:
                air_session._set_session(None)

        self.thread = threading.Thread(
            target=_run, name=f"train-rank-{self.world_rank}", daemon=True)
        self.thread.start()

    def get_next_result(self, timeout: Optional[float] = None) -> dict:
        """Blocks until the worker reports or finishes, then lets it
        continue. timeout=None blocks indefinitely (a dead train thread
        always pushes a finished sentinel, so this cannot hang silently);
        pass a float to surface report gaps as {'timeout': True}."""
        self._chaos_gate("train.result_delay_ms")
        import queue as _q
        try:
            item = self.session.result_queue.get(timeout=timeout)
        except _q.Empty:
            return {"timeout": True}
        if not item.get("finished"):
            self.session.continue_event.set()
        return item

    def request_stop(self) -> None:
        if self.session is not None:
            self.session.stop_requested = True
            self.session.continue_event.set()

    def shutdown(self) -> None:
        self.request_stop()


def _wants_config(fn: Callable) -> bool:
    import inspect
    try:
        return len(inspect.signature(fn).parameters) >= 1
    except (TypeError, ValueError):
        return False


class WorkerGroup:
    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK",
                 bundles: Optional[List[Dict[str, float]]] = None,
                 runtime_env: Optional[Dict[str, Any]] = None):
        self.num_workers = num_workers
        self._pg: Optional[PlacementGroup] = placement_group(
            bundles or [dict(resources_per_worker)
                        for _ in range(num_workers)],
            strategy=placement_strategy)
        self.workers: List[Any] = []
        for rank in range(num_workers):
            worker_cls = TrainWorker.options(
                num_cpus=resources_per_worker.get("CPU", 1),
                num_gpus=resources_per_worker.get("GPU", 0),
                resources={k: v for k, v in resources_per_worker.items()
                           if k not in ("CPU", "GPU", "memory")},
                placement_group=self._pg,
                placement_group_bundle_index=rank,
                max_concurrency=4,
                runtime_env=runtime_env,
            )
            self.workers.append(worker_cls.remote(rank, num_workers))

    def execute(self, method: str, *args, **kwargs) -> List[Any]:
        """Call a method on every worker, gather results."""
        refs = [getattr(w, method).remote(*args, **kwargs)
                for w in self.workers]
        return ray_tpu_torch.get(refs)

    def execute_async(self, method: str, *args, **kwargs):
        return [getattr(w, method).remote(*args, **kwargs)
                for w in self.workers]

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.get(w.shutdown.remote(), timeout=5)
            except Exception:  # noqa: BLE001
                pass
            ray_tpu_torch.kill(w)
        if self._pg is not None:
            remove_placement_group(self._pg)
            self._pg = None

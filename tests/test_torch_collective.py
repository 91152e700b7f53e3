"""``ray_tpu_torch.util``'s collective, ActorPool and Queue: the copies
of ``ray_tpu/util/{collective,actor_pool,queue}.py``.

The tests of tests/test_util.py, by the same names, on the port's
runtime (this file's ``ray_start_regular`` fixture shadows
tests/conftest.py's). Then allreduce on the star path and on the ring
path for float64, int64, float16 and bool inputs, the port's actors
passing torch tensors, held to the JAX package's actors on the same
arrays: the same values and the same dtypes (the star path reduces as
jnp does, float64 to float32 and int64 to int32; the ring path keeps the
input's dtype).
"""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Queue


@pytest.fixture
def ray_start_regular():
    """A fresh small cluster of the port per test."""
    ray_tpu_torch.shutdown()
    ctx = ray_tpu_torch.init(num_cpus=8, num_gpus=0, _memory=1e9)
    yield ctx
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class _Worker:
    def __init__(self, rank, world):
        self.rank = rank
        self.world = world

    def init_collective_group(self, world_size, rank, backend, group_name):
        from ray_tpu_torch.util import collective
        collective.init_collective_group(world_size, rank, backend,
                                         group_name)
        return True

    def do_allreduce(self, value):
        from ray_tpu_torch.util import collective
        return collective.allreduce(np.array([value], dtype=np.float32))

    def do_allgather(self):
        from ray_tpu_torch.util import collective
        return collective.allgather(np.array([self.rank]))

    def do_broadcast(self):
        from ray_tpu_torch.util import collective
        return collective.broadcast(np.array([42.0 + self.rank]), src_rank=1)

    def do_reducescatter(self):
        from ray_tpu_torch.util import collective
        return collective.reducescatter(
            np.arange(self.world, dtype=np.float32))

    def do_barrier(self):
        from ray_tpu_torch.util import collective
        collective.barrier()
        return self.rank

    def do_send(self, dst):
        from ray_tpu_torch.util import collective
        collective.send(np.array([self.rank * 100]), dst)
        return True

    def do_recv(self, src):
        from ray_tpu_torch.util import collective
        return collective.recv(src)

    def rank_info(self):
        from ray_tpu_torch.util import collective
        return (collective.get_rank(),
                collective.get_collective_group_size())


def _make_group(n):
    from ray_tpu_torch.util import collective
    workers = [_Worker.remote(i, n) for i in range(n)]
    collective.create_collective_group(workers, n, list(range(n)))
    return workers


def test_collective_allreduce(ray_start_regular):
    workers = _make_group(4)
    out = ray_tpu_torch.get([w.do_allreduce.remote(float(i + 1))
                       for i, w in enumerate(workers)])
    for o in out:
        assert o[0] == pytest.approx(1 + 2 + 3 + 4)


def test_collective_allgather_broadcast(ray_start_regular):
    workers = _make_group(3)
    gathered = ray_tpu_torch.get([w.do_allgather.remote() for w in workers])
    for g in gathered:
        assert [int(x[0]) for x in g] == [0, 1, 2]
    bcast = ray_tpu_torch.get([w.do_broadcast.remote() for w in workers])
    for b in bcast:
        assert b[0] == pytest.approx(43.0)  # rank 1's value


def test_collective_reducescatter_barrier_rank(ray_start_regular):
    workers = _make_group(2)
    rs = ray_tpu_torch.get([w.do_reducescatter.remote() for w in workers])
    assert rs[0][0] == pytest.approx(0.0)  # sum of [0,1] over 2 ranks → [0],[2]
    assert rs[1][0] == pytest.approx(2.0)
    assert sorted(ray_tpu_torch.get([w.do_barrier.remote() for w in workers])) == [0, 1]
    info = ray_tpu_torch.get(workers[1].rank_info.remote())
    assert info == (1, 2)


def test_collective_send_recv(ray_start_regular):
    workers = _make_group(2)
    send_ref = workers[0].do_send.remote(1)
    out = ray_tpu_torch.get(workers[1].do_recv.remote(0))
    assert ray_tpu_torch.get(send_ref) is True
    assert out[0] == 0


def test_actor_pool_map(ray_start_regular):
    @ray_tpu_torch.remote
    class A:
        def double(self, x):
            return x * 2

    pool = ActorPool([A.remote() for _ in range(2)])
    out = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    assert out == [i * 2 for i in range(8)]


def test_actor_pool_unordered_and_reuse(ray_start_regular):
    @ray_tpu_torch.remote
    class A:
        def work(self, x):
            return x + 1

    pool = ActorPool([A.remote()])
    out = sorted(pool.map_unordered(lambda a, v: a.work.remote(v), range(5)))
    assert out == [1, 2, 3, 4, 5]
    assert pool.has_free()
    a = pool.pop_idle()
    assert a is not None
    pool.push(a)


def test_queue_basic(ray_start_regular):
    q = Queue(maxsize=4)
    q.put(1)
    q.put(2)
    assert q.qsize() == 2
    assert q.get() == 1
    assert q.get() == 2
    assert q.empty()
    with pytest.raises(Empty):
        q.get_nowait()
    q.put_nowait_batch([1, 2, 3])
    assert q.get_nowait_batch(3) == [1, 2, 3]
    q.shutdown()


def test_queue_blocking_producer_consumer(ray_start_regular):
    q = Queue()

    @ray_tpu_torch.remote
    def producer(q, n):
        for i in range(n):
            q.put(i)
        return True

    @ray_tpu_torch.remote
    def consumer(q, n):
        return [q.get(timeout=5) for _ in range(n)]

    pref = producer.remote(q, 5)
    cref = consumer.remote(q, 5)
    assert ray_tpu_torch.get(cref) == list(range(5))
    assert ray_tpu_torch.get(pref)


def test_collective_ring_allreduce_large(ray_start_regular):
    """Arrays above _INLINE_LIMIT take the ring path (scatter-reduce +
    allgather over P2P refs): numerically identical to the star path,
    but no single process carries world x bytes. Forced here by shrinking
    the inline limit so a small array exercises the ring."""
    import ray_tpu_torch
    from ray_tpu_torch.util import collective as C
    orig_limit = C._INLINE_LIMIT

    @ray_tpu_torch.remote
    class RingWorker:
        def __init__(self, rank, world):
            self.rank, self.world = rank, world

        def setup(self, world_size, rank):
            from ray_tpu_torch.util import collective
            collective._INLINE_LIMIT = 0  # force ring + ref data path
            collective.init_collective_group(world_size, rank, "tpu",
                                             "ring")
            return True

        def do_allreduce(self, shape, op):
            from ray_tpu_torch.util import collective
            arr = np.full(shape, float(self.rank + 1), np.float32)
            arr[0] = self.rank  # non-uniform content
            out = collective.allreduce(arr, "ring", op)
            # The out-of-band data path really engaged: sends pinned
            # ObjectRefs in the per-channel keep-alive window.
            g = collective._groups()["ring"]
            assert g.p2p_live and all(len(d) > 0
                                      for d in g.p2p_live.values())
            return out

    world = 4
    workers = [RingWorker.remote(r, world) for r in range(world)]
    ray_tpu_torch.get([w.setup.remote(world, r)
                 for r, w in enumerate(workers)])
    # Odd length: chunks split unevenly across the ring.
    outs = ray_tpu_torch.get([w.do_allreduce.remote((103,), "sum")
                        for w in workers])
    expected = np.full((103,), float(sum(r + 1 for r in range(world))),
                       np.float32)
    expected[0] = float(sum(range(world)))
    for out in outs:
        np.testing.assert_allclose(out, expected, rtol=1e-6)
    try:
        # max over the ring too
        outs = ray_tpu_torch.get([w.do_allreduce.remote((57,), "max")
                            for w in workers])
        for out in outs:
            assert out[0] == world - 1 and out[1] == world
    finally:
        # Actors share this process (thread backend): restore the module
        # global so later collective tests exercise the star path again.
        C._INLINE_LIMIT = orig_limit


# ---------------------------------------------------------------------------
# Dtypes on both paths, against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both_clusters():
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, _memory=1e9)
    ray_tpu.init(num_cpus=4, num_tpus=0, _memory=1e9)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


class _Reducer:
    """One rank of a group in either package: its module's collective
    (``package`` names it), its inputs as torch tensors in the port's."""

    def __init__(self, package, rank, world, group):
        import importlib
        self.collective = importlib.import_module(f"{package}.util.collective")
        self.torch = package == "ray_tpu_torch"
        self.rank, self.world, self.group = rank, world, group

    def setup(self):
        # The group registry is per thread: the thread of the calls.
        self.collective.init_collective_group(self.world, self.rank, "tpu",
                                              self.group)

    def allreduce(self, array, op, bf16=False):
        """``array`` reduced; with ``bf16`` as a bfloat16 tensor or JAX
        array of its (exactly representable) values."""
        x = torch.from_numpy(array) if self.torch else array
        if bf16:
            import jax.numpy as jnp
            x = x.bfloat16() if self.torch else jnp.asarray(x, jnp.bfloat16)
        out = self.collective.allreduce(x, self.group, op)
        return np.asarray(out), str(np.asarray(out).dtype)


def _inputs(dtype, rank):
    rng = np.random.default_rng(rank)
    if dtype == "bool":
        return rng.integers(0, 2, 37).astype(bool)
    if dtype == "int64":
        return rng.integers(-2**40, 2**40, 37)
    if dtype == "bfloat16":
        # float32 values that bfloat16 holds exactly.
        x = torch.from_numpy((rng.normal(size=37) * 100).astype(np.float32))
        return x.bfloat16().float().numpy()
    return (rng.normal(size=37) * 100).astype(dtype)


# What each path gives for each input dtype, as the JAX package's does.
STAR = {"float64": "float32", "int64": "int32", "float16": "float16",
        "bool": "bool", "bfloat16": "bfloat16"}
# Where the port's dtype is another: numpy has no bfloat16 without
# ml_dtypes, so the port reduces a bfloat16 tensor as its float32 values,
# and gives what the JAX package gives for those.
PORT = {"bfloat16": "float32"}


@pytest.mark.parametrize("dtype", sorted(STAR))
@pytest.mark.parametrize("path", ["star", "ring"])
def test_allreduce_dtypes_match_jax(both_clusters, path, dtype):
    from ray_tpu.util import collective as jcollective
    from ray_tpu_torch.util import collective as tcollective
    world, op = 3, ("max" if dtype == "bool" else "sum")
    limits = (jcollective._INLINE_LIMIT, tcollective._INLINE_LIMIT)
    if path == "ring":
        # Actors share this process (thread backend): every array is
        # above the limit, so allreduce takes the ring.
        jcollective._INLINE_LIMIT = tcollective._INLINE_LIMIT = 0
    bf16 = dtype == "bfloat16"
    runs = [("ray_tpu", ray_tpu, bf16), ("ray_tpu_torch", ray_tpu_torch, bf16)]
    if bf16:
        # The JAX package on the float32 values the port reduces.
        runs.append(("ray_tpu", ray_tpu, False))
    try:
        results = []
        for package, mod, as_bf16 in runs:
            group = f"{path}-{dtype}-{as_bf16}"
            actors = [mod.remote(_Reducer).remote(package, r, world, group)
                      for r in range(world)]
            mod.get([a.setup.remote() for a in actors])
            results.append(mod.get([
                a.allreduce.remote(_inputs(dtype, r), op, as_bf16)
                for r, a in enumerate(actors)]))
    finally:
        jcollective._INLINE_LIMIT, tcollective._INLINE_LIMIT = limits
    want_dtype = STAR[dtype] if path == "star" else dtype
    for (want, jax_dtype), (got, got_dtype), *values in zip(*results):
        assert jax_dtype == want_dtype
        assert got_dtype == PORT.get(jax_dtype, jax_dtype)
        np.testing.assert_array_equal(got, values[0][0] if bf16 else want)

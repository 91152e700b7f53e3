"""Data on the port's runtime: ``ray_tpu_torch.data``, the copy of
``ray_tpu/data``.

The tests of tests/test_data.py and tests/test_data_images_tfrecords.py,
by the same names, on the port's copies (their clusters are the port's:
this file's ``ray_shared`` and ``ray_start_regular`` fixtures shadow
tests/conftest.py's). ``test_iter_jax_batches`` becomes
``test_iter_torch_batches``, which holds the port's tensors to the JAX
package's batches on the same Dataset, dtypes included; ``from_torch`` is
held to ``from_jax``.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu_torch import data
from ray_tpu_torch import data as rdata
from ray_tpu_torch.data import ActorPoolStrategy
from ray_tpu_torch.data import tfrecord as tfr


@pytest.fixture(scope="module")
def ray_shared():
    """Module-scoped clusters of both packages: the port's for the tests,
    the JAX package's for the batches the port's are held to."""
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()
    ctx = ray_tpu_torch.init(num_cpus=8, num_gpus=0, _memory=1e9)
    ray_tpu.init(num_cpus=4, num_tpus=0, _memory=1e9)
    yield ctx
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_regular():
    """A fresh small cluster of the port per test."""
    ray_tpu_torch.shutdown()
    ctx = ray_tpu_torch.init(num_cpus=8, num_gpus=0, _memory=1e9)
    yield ctx
    ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# tests/test_data.py
# ---------------------------------------------------------------------------


def test_range_count_take(ray_shared):
    ds = data.range(100, parallelism=4)
    assert ds.count() == 100
    assert ds.num_blocks() == 4
    rows = ds.take(5)
    assert rows == [{"id": i} for i in range(5)]


def test_from_items_simple(ray_shared):
    ds = data.from_items([1, 2, 3, 4, 5], parallelism=2)
    assert ds.count() == 5
    assert sorted(ds.take_all()) == [1, 2, 3, 4, 5]


def test_from_items_dicts(ray_shared):
    ds = data.from_items([{"a": i, "b": i * 2} for i in range(10)])
    assert ds.count() == 10
    assert ds.take(1) == [{"a": 0, "b": 0}]


def test_map_batches_numpy(ray_shared):
    ds = data.range(32, parallelism=2)
    out = ds.map_batches(lambda b: {"id": b["id"] * 2})
    vals = [r["id"] for r in out.take_all()]
    assert vals == [i * 2 for i in range(32)]


def test_map_batches_pandas(ray_shared):
    ds = data.range(10, parallelism=2)

    def add_col(df):
        df = df.copy()
        df["y"] = df["id"] + 1
        return df

    out = ds.map_batches(add_col, batch_format="pandas")
    assert out.take(2) == [{"id": 0, "y": 1}, {"id": 1, "y": 2}]


def test_map_batches_fusion(ray_shared):
    ds = data.range(20, parallelism=2)
    out = ds.map_batches(lambda b: {"id": b["id"] + 1}).map_batches(
        lambda b: {"id": b["id"] * 10})
    assert out._plan.stage_names() == ["map_batches", "map_batches"]
    vals = [r["id"] for r in out.take_all()]
    assert vals == [(i + 1) * 10 for i in range(20)]


def test_map_filter_flat_map(ray_shared):
    ds = data.range(10, parallelism=2)
    out = ds.map(lambda r: {"id": r["id"] + 100})
    assert out.take(1) == [{"id": 100}]
    out2 = ds.filter(lambda r: r["id"] % 2 == 0)
    assert out2.count() == 5
    ds3 = data.from_items([1, 2, 3])
    out3 = ds3.flat_map(lambda x: [x, x])
    assert out3.count() == 6


def test_actor_pool_strategy(ray_shared):
    ds = data.range(16, parallelism=4)
    out = ds.map_batches(lambda b: {"id": b["id"] + 1},
                         compute=ActorPoolStrategy(1, 2))
    assert sorted(r["id"] for r in out.take_all()) == list(range(1, 17))


def test_map_batches_callable_class(ray_shared):
    class AddN:
        def __init__(self, n):
            self.n = n

        def __call__(self, batch):
            return {"id": batch["id"] + self.n}

    ds = data.range(8, parallelism=2)
    out = ds.map_batches(AddN, fn_constructor_args=(5,),
                         compute=ActorPoolStrategy(1, 1))
    assert sorted(r["id"] for r in out.take_all()) == list(range(5, 13))


def test_repartition(ray_shared):
    ds = data.range(100, parallelism=2)
    out = ds.repartition(10)
    assert out.num_blocks() == 10
    assert out.count() == 100
    # non-shuffling repartition preserves global order
    assert [r["id"] for r in out.take_all()] == list(range(100))


def test_random_shuffle(ray_shared):
    ds = data.range(100, parallelism=4)
    out = ds.random_shuffle(seed=42)
    vals = [r["id"] for r in out.take_all()]
    assert sorted(vals) == list(range(100))
    assert vals != list(range(100))


def test_sort(ray_shared):
    rng = np.random.default_rng(0)
    items = [{"x": int(v)} for v in rng.permutation(50)]
    ds = data.from_items(items, parallelism=4)
    out = ds.sort("x")
    assert [r["x"] for r in out.take_all()] == list(range(50))
    out_desc = ds.sort("x", descending=True)
    assert [r["x"] for r in out_desc.take_all()] == list(range(49, -1, -1))


def test_groupby_aggregate(ray_shared):
    items = [{"k": i % 3, "v": i} for i in range(30)]
    ds = data.from_items(items, parallelism=4)
    out = ds.groupby("k").sum("v")
    rows = {r["k"]: r["sum(v)"] for r in out.take_all()}
    expect = {}
    for i in range(30):
        expect[i % 3] = expect.get(i % 3, 0) + i
    assert rows == expect


def test_global_aggregates(ray_shared):
    ds = data.range(100, parallelism=4)
    assert ds.sum("id") == sum(range(100))
    assert ds.min("id") == 0
    assert ds.max("id") == 99
    assert ds.mean("id") == pytest.approx(49.5)
    assert ds.std("id") == pytest.approx(np.std(np.arange(100), ddof=1))


def test_split(ray_shared):
    ds = data.range(100, parallelism=10)
    shards = ds.split(4)
    assert len(shards) == 4
    assert sum(s.count() for s in shards) == 100
    eq = ds.split(3, equal=True)
    counts = [s.count() for s in eq]
    assert counts == [33, 33, 33]


def test_split_at_indices(ray_shared):
    ds = data.range(10, parallelism=2)
    a, b, c = ds.split_at_indices([3, 7])
    assert [r["id"] for r in a.take_all()] == [0, 1, 2]
    assert [r["id"] for r in b.take_all()] == [3, 4, 5, 6]
    assert [r["id"] for r in c.take_all()] == [7, 8, 9]


def test_limit_union_zip(ray_shared):
    ds = data.range(10, parallelism=2)
    assert ds.limit(4).count() == 4
    u = ds.union(data.range(5))
    assert u.count() == 15
    z = data.range(6, parallelism=2).zip(
        data.range(6, parallelism=3).map_batches(
            lambda b: {"y": b["id"] * 2}))
    rows = z.take_all()
    assert rows[3] == {"id": 3, "y": 6}


def test_iter_batches(ray_shared):
    ds = data.range(25, parallelism=3)
    batches = list(ds.iter_batches(batch_size=10))
    assert [len(b["id"]) for b in batches] == [10, 10, 5]
    batches = list(ds.iter_batches(batch_size=10, drop_last=True))
    assert [len(b["id"]) for b in batches] == [10, 10]
    # pandas format
    dfb = next(iter(ds.iter_batches(batch_size=5, batch_format="pandas")))
    assert list(dfb.columns) == ["id"]


def _batches(make, dtypes):
    got = list(make(data).iter_torch_batches(batch_size=4, device="cpu",
                                             dtypes=dtypes))
    want = list(make(jdata).iter_jax_batches(batch_size=4, dtypes=dtypes))
    return got, want


def test_iter_torch_batches(ray_shared):
    """Tensors with the values and dtypes of the JAX package's
    iter_jax_batches on the same Dataset: 64-bit columns become 32-bit,
    the others keep their type; a ``dtypes`` cast comes first."""
    rng = np.random.default_rng(0)
    cols = {"i64": rng.integers(-9, 9, 10), "f64": rng.normal(size=10),
            "u8": rng.integers(0, 255, 10).astype(np.uint8),
            "f16": rng.normal(size=10).astype(np.float16),
            "ok": rng.integers(0, 2, 10).astype(bool)}
    rows = [{k: v[i] for k, v in cols.items()} for i in range(10)]
    tensors = rng.normal(size=(10, 2, 3))
    cases = [(lambda m: m.from_items(rows, parallelism=3), None),
             (lambda m: m.from_items(rows, parallelism=3),
              {"i64": np.float64, "u8": np.int64}),
             (lambda m: m.from_numpy(tensors), None)]
    for make, dtypes in cases:
        got, want = _batches(make, dtypes)
        assert len(got) == len(want) == 2  # drop_last by default
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k, v in w.items():
                assert isinstance(g[k], torch.Tensor), k
                assert g[k].device.type == "cpu"
                t = g[k].numpy()
                assert t.dtype == np.dtype(v.dtype), (k, t.dtype, v.dtype)
                np.testing.assert_array_equal(t, np.asarray(v), err_msg=k)
    shard = data.range(8, parallelism=2).streaming_split(2)[1]
    batch = next(iter(shard.iter_torch_batches(batch_size=2,
                                               device="cpu")))
    assert batch["id"].dtype == torch.int32


def test_iter_torch_batches_default_to_the_card(ray_shared):
    """``device=None`` is the card, and raises where there is none."""
    ds = data.range(8, parallelism=2)
    if torch.cuda.is_available():
        batch = next(iter(ds.iter_torch_batches(batch_size=4)))
        assert batch["id"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(iter(ds.iter_torch_batches(batch_size=4)))


def test_from_torch_matches_from_jax(ray_shared):
    arrays = [np.arange(12, dtype=np.float32).reshape(3, 4),
              np.ones((2, 4), np.float32)]
    got = data.from_torch([torch.from_numpy(a) for a in arrays])
    want = jdata.from_jax([jnp.asarray(a) for a in arrays])
    assert got.count() == want.count() == 5
    for g, w in zip(got.iter_rows(), want.iter_rows()):
        np.testing.assert_array_equal(np.asarray(g["data"]),
                                      np.asarray(w["data"]))
    single = data.from_torch(torch.arange(3.0, requires_grad=True))
    assert single.count() == 3
    # numpy has no bfloat16 without ml_dtypes: a bfloat16 tensor's rows
    # are its float32 values, where from_jax refuses a bfloat16 array
    # (pyarrow has no type for it).
    got = data.from_torch(torch.from_numpy(arrays[0]).bfloat16())
    want = jdata.from_jax(jnp.asarray(arrays[0]))
    for g, w in zip(got.iter_rows(), want.iter_rows()):
        assert np.asarray(g["data"]).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(g["data"]),
                                      np.asarray(w["data"]))
    with pytest.raises(pa.ArrowNotImplementedError):
        jdata.from_jax(jnp.asarray(arrays[0], jnp.bfloat16)).count()


def test_parquet_roundtrip(ray_shared, tmp_path):
    ds = data.range(20, parallelism=2)
    path = str(tmp_path / "pq")
    ds.write_parquet(path)
    back = data.read_parquet(path)
    assert back.count() == 20
    assert sorted(r["id"] for r in back.take_all()) == list(range(20))
    assert back.input_files()


def test_csv_json_roundtrip(ray_shared, tmp_path):
    ds = data.from_items([{"a": i, "b": f"s{i}"} for i in range(10)],
                         parallelism=2)
    csv_path = str(tmp_path / "csv")
    ds.write_csv(csv_path)
    assert data.read_csv(csv_path).count() == 10
    json_path = str(tmp_path / "json")
    ds.write_json(json_path)
    back = data.read_json(json_path)
    assert back.count() == 10
    assert back.take(1) == [{"a": 0, "b": "s0"}]


def test_numpy_roundtrip(ray_shared, tmp_path):
    ds = data.from_numpy(np.arange(12).reshape(6, 2))
    assert ds.count() == 6
    batch = next(iter(ds.iter_batches(batch_size=6)))
    np.testing.assert_array_equal(batch["data"],
                                  np.arange(12).reshape(6, 2))
    path = str(tmp_path / "np")
    ds.write_numpy(path)
    assert data.read_numpy(path).count() == 6


def test_range_tensor(ray_shared):
    ds = data.range_tensor(10, shape=(2, 2), parallelism=2)
    batch = next(iter(ds.iter_batches(batch_size=10)))
    assert batch["data"].shape == (10, 2, 2)
    assert batch["data"][3, 0, 0] == 3


def test_select_drop_add_columns(ray_shared):
    ds = data.from_items([{"a": i, "b": i * 2, "c": 0} for i in range(5)])
    assert ds.select_columns(["a"]).take(1) == [{"a": 0}]
    assert set(ds.drop_columns(["c"]).take(1)[0]) == {"a", "b"}
    out = ds.add_column("d", lambda df: df["a"] + df["b"])
    assert out.take(2)[1]["d"] == 3


def test_unique_and_schema(ray_shared):
    ds = data.from_items([{"k": i % 3} for i in range(9)])
    assert ds.unique("k") == [0, 1, 2]
    assert "k" in ds.columns()


def test_preprocessors(ray_shared):
    ds = data.from_items([{"x": float(i), "label": "ab"[i % 2]}
                          for i in range(10)])
    scaler = data.StandardScaler(["x"])
    out = scaler.fit_transform(ds)
    vals = np.array([r["x"] for r in out.take_all()])
    assert abs(vals.mean()) < 1e-9
    le = data.LabelEncoder("label")
    out2 = le.fit_transform(ds)
    assert set(r["label"] for r in out2.take_all()) == {0, 1}
    mm = data.MinMaxScaler(["x"])
    out3 = mm.fit_transform(ds)
    vals3 = [r["x"] for r in out3.take_all()]
    assert min(vals3) == 0.0 and max(vals3) == 1.0
    chain = data.Chain(data.MinMaxScaler(["x"]),
                       data.Concatenator(include=["x"]))
    out4 = chain.fit_transform(ds)
    assert out4.take(1)[0]["concat_out"] == [0.0]


def test_batch_mapper_one_hot(ray_shared):
    ds = data.from_items([{"c": "xy"[i % 2]} for i in range(4)])
    ohe = data.OneHotEncoder(["c"])
    out = ohe.fit_transform(ds)
    row = out.take(1)[0]
    assert row["c_x"] == 1.0 and row["c_y"] == 0.0


def test_dataset_pipeline(ray_shared):
    ds = data.range(20, parallelism=4)
    pipe = ds.window(blocks_per_window=2)
    assert pipe.count() == 20
    pipe2 = ds.repeat(3)
    assert pipe2.count() == 60
    mapped = ds.window(blocks_per_window=2).map_batches(
        lambda b: {"id": b["id"] + 1})
    assert sorted(r["id"] for r in
                  [row for row in mapped.iter_rows()]) == list(range(1, 21))


def test_read_text(ray_shared, tmp_path):
    p = tmp_path / "f.txt"
    p.write_text("hello\nworld\n")
    ds = data.read_text(str(p))
    assert [r["text"] for r in ds.take_all()] == ["hello", "world"]


def test_randomize_block_order(ray_shared):
    ds = data.range(40, parallelism=8).randomize_block_order(seed=1)
    assert sorted(r["id"] for r in ds.take_all()) == list(range(40))


def test_local_shuffle_iter(ray_shared):
    ds = data.range(32, parallelism=2)
    batches = list(ds.iter_batches(batch_size=16,
                                   local_shuffle_buffer_size=16,
                                   local_shuffle_seed=7))
    all_vals = sorted(v for b in batches for v in b["id"].tolist())
    assert all_vals == list(range(32))


def test_streaming_executor_pipelines_blocks(ray_shared):
    """Blocks flow through the operator chain without full materialization:
    the first batch arrives after one block traverses, and ordering holds."""
    import time
    from ray_tpu_torch import data as rdata

    ds = rdata.range(64, parallelism=8).map_batches(
        lambda b: {"id": b["id"] * 2})
    # Chain a second, non-fusable stage (different num_cpus forces a
    # separate operator) — the streaming executor pipelines across them.
    ds = ds.map_batches(lambda b: {"id": b["id"] + 1}, num_cpus=0.5)
    assert not ds._plan.is_executed()
    it = ds.iter_batches(batch_size=8)
    first = next(it)
    assert list(first["id"])[:3] == [1, 3, 5]
    rest = list(it)
    all_ids = list(first["id"]) + [i for b in rest for i in b["id"]]
    assert all_ids == [2 * i + 1 for i in range(64)]


def test_streaming_executor_with_alltoall_barrier(ray_shared):
    from ray_tpu_torch import data as rdata

    ds = (rdata.range(32, parallelism=4)
          .map_batches(lambda b: {"id": b["id"]})
          .repartition(2)
          .map_batches(lambda b: {"id": b["id"] * 10}, num_cpus=0.5))
    vals = sorted(v for b in ds.iter_batches(batch_size=None)
                  for v in b["id"])
    assert vals == [i * 10 for i in range(32)]
    assert ds.num_blocks() == 2


def test_streaming_executor_actor_pool(ray_shared):
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.data import ActorPoolStrategy

    class Doubler:
        def __call__(self, batch):
            return {"id": batch["id"] * 2}

    ds = rdata.range(16, parallelism=4).map_batches(
        Doubler, compute=ActorPoolStrategy(min_size=2, max_size=2))
    vals = [v for b in ds.iter_batches(batch_size=None) for v in b["id"]]
    assert vals == [2 * i for i in range(16)]


def test_streaming_partial_consumption_no_cache(ray_shared):
    from ray_tpu_torch import data as rdata

    ds = rdata.range(32, parallelism=8).map_batches(
        lambda b: {"id": b["id"]})
    it = ds.iter_batches(batch_size=4)
    next(it)
    # partial consumption must not mark the plan as executed
    assert not ds._plan.is_executed()
    # a full pass still sees every row
    total = sum(len(b["id"]) for b in ds.iter_batches(batch_size=4))
    assert total == 32


def test_streaming_split_disjoint_and_complete(ray_shared):
    from ray_tpu_torch import data as rdata

    ds = rdata.range(48, parallelism=6).map_batches(
        lambda b: {"id": b["id"] * 3})
    its = ds.streaming_split(3)
    assert len(its) == 3
    shards = [sorted(v for b in it.iter_batches(batch_size=None)
                     for v in b["id"]) for it in its]
    # disjoint and complete
    all_vals = sorted(v for s in shards for v in s)
    assert all_vals == [3 * i for i in range(48)]
    assert all(s for s in shards)
    assert sum(it.count() for it in its) == 48
    import pytest as _pytest
    with _pytest.raises(ValueError):
        ds.streaming_split(0)


def test_streaming_backpressure_bounds_in_flight_bytes(ray_shared):
    """Resource-aware backpressure: with a byte budget smaller than the
    dataset, upstream launches are throttled — the topology's buffered
    bytes stay within budget + one block, instead of growing with the
    input count (reference: streaming executor resource accounting)."""
    from ray_tpu_torch.data._internal.execution import (ExecutionOptions,
                                                  InputDataBuffer,
                                                  MapOperator,
                                                  StreamingExecutor)
    from ray_tpu_torch.data.block import BlockMetadata

    block = list(range(1000))  # metadata size drives the accounting
    n = 24
    blocks = [ray_tpu_torch.put(block) for _ in range(n)]
    metas = [BlockMetadata(num_rows=1000, size_bytes=8000)
             for _ in range(n)]

    ops = [InputDataBuffer(blocks, metas),
           MapOperator("m1", lambda b: b, max_in_flight=32),
           MapOperator("m2", lambda b: b, max_in_flight=32)]
    budget = 3 * 8000  # 3 blocks worth
    ex = StreamingExecutor(ExecutionOptions(max_in_flight_bytes=budget))

    peak = 0
    seen = 0
    for _bundle in ex.execute(ops):
        seen += 1
        usage = sum(op.buffered_bytes() for op in ops[1:])
        peak = max(peak, usage)
    assert seen == n
    # Suffix budgeting bounds each operator to ~budget with one block of
    # check-then-launch slack; the chain total is O(budget), not O(n):
    # ~650KB when unthrottled (every block materialized at once).
    assert peak <= 2 * (budget + 8000) + 8000, peak


def test_streaming_backpressure_off_without_sizes(ray_shared):
    """Blocks without size metadata fall back to count-based bounds
    only — the byte budget cannot throttle what it cannot measure."""
    from ray_tpu_torch import data as rdata

    ds = rdata.range(16, parallelism=4).map_batches(lambda b: b)
    assert ds.count() == 16


def test_arrow_tensor_extension_roundtrip(ray_shared):
    """Rank>=2 batch columns ride the ArrowTensorType extension
    (reference: data/extensions/tensor_extension.py): zero-copy
    from/to numpy, surviving slices and dataset map stages."""
    import numpy as np
    import pyarrow as pa

    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.data.extensions import ArrowTensorArray, ArrowTensorType

    a = np.arange(60, dtype=np.float32).reshape(5, 4, 3)
    col = ArrowTensorArray.from_numpy(a)
    assert isinstance(col.type, ArrowTensorType)
    assert col.type.shape == (4, 3)
    np.testing.assert_array_equal(col.to_numpy(), a)
    # Table slice keeps tensor semantics.
    t = pa.table({"img": col})
    np.testing.assert_array_equal(
        t.slice(2, 2)["img"].combine_chunks().to_numpy(), a[2:4])

    # End-to-end: map_batches producing an image-shaped column.
    ds = rdata.range(8, parallelism=2).map_batches(
        lambda b: {"img": np.ones((len(b["id"]), 6, 6), np.float32)
                   * np.asarray(b["id"], np.float32)[:, None, None]})
    batches = list(ds.iter_batches(batch_size=None))
    got = np.concatenate([b["img"] for b in batches])
    assert got.shape == (8, 6, 6)
    assert sorted(int(img[0, 0]) for img in got) == list(range(8))


def test_arrow_tensor_extension_sliced_blocks(ray_shared):
    """Sliced tensor columns (limit / iter_rows paths) must respect the
    slice offset, and zero-size element shapes fall back cleanly."""
    import numpy as np

    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.data.extensions import ArrowTensorArray

    a = np.arange(24, dtype=np.float32).reshape(6, 2, 2)
    col = ArrowTensorArray.from_numpy(a)
    np.testing.assert_array_equal(
        col.slice(2, 3).to_numpy(zero_copy_only=False), a[2:5])

    ds = rdata.range(8, parallelism=2).map_batches(
        lambda b: {"img": np.ones((len(b["id"]), 2, 2), np.float32)})
    rows = ds.limit(3).take_all()
    assert len(rows) == 3
    assert np.asarray(rows[0]["img"]).shape == (2, 2)
    # Zero-size element shape: legacy list columns, no crash.
    ds0 = rdata.range(4, parallelism=1).map_batches(
        lambda b: {"x": np.zeros((len(b["id"]), 0), np.float32)})
    assert ds0.count() == 4


# ---------------------------------------------------------------------------
# tests/test_data_images_tfrecords.py
# ---------------------------------------------------------------------------

# -- wire codec units ----------------------------------------------------

def test_crc32c_known_vectors():
    # RFC 3720 test vectors.
    assert tfr.crc32c(b"") == 0x0
    assert tfr.crc32c(b"123456789") == 0xE3069283
    assert tfr.crc32c(bytes(32)) == 0x8A9136AA


def test_example_roundtrip_all_feature_types():
    row = {
        "name": [b"hello", b"world"],
        "score": [1.5, -2.25],
        "count": [7, -3, 1 << 40],
        "single": [42],
    }
    data = tfr.encode_example(row)
    back = tfr.decode_example(data)
    assert back["name"] == [b"hello", b"world"]
    np.testing.assert_allclose(back["score"], [1.5, -2.25])
    assert back["count"] == [7, -3, 1 << 40]
    assert back["single"] == [42]


def test_example_encodes_python_scalars_and_strings():
    data = tfr.encode_example({"s": "text", "i": 5, "f": [0.5]})
    back = tfr.decode_example(data)
    assert back["s"] == [b"text"]
    assert back["i"] == [5]
    np.testing.assert_allclose(back["f"], [0.5])


def test_tfrecord_file_framing_and_corruption(tmp_path):
    path = str(tmp_path / "a.tfrecord")
    records = [b"first", b"second" * 100, b""]
    tfr.write_tfrecord_file(path, records)
    assert list(tfr.read_tfrecord_file(path)) == records
    # Flip a data byte: the masked CRC must catch it.
    blob = bytearray(open(path, "rb").read())
    blob[14] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="crc"):
        list(tfr.read_tfrecord_file(path))


# -- dataset-level -------------------------------------------------------

def test_write_read_tfrecords_roundtrip(tmp_path, ray_start_regular):
    ds = rdata.from_items(
        [{"id": i, "name": f"row{i}", "val": float(i) / 2}
         for i in range(20)], parallelism=3)
    out = str(tmp_path / "records")
    ds.write_tfrecords(out)
    import os
    files = sorted(os.listdir(out))
    assert len(files) == 3 and all(f.endswith(".tfrecord")
                                   for f in files)
    back = rdata.read_tfrecords(out)
    rows = sorted(back.take_all(), key=lambda r: r["id"])
    assert len(rows) == 20
    assert rows[3]["id"] == 3
    assert rows[3]["name"] == b"row3"  # bytes feature (tf semantics)
    assert rows[3]["val"] == pytest.approx(1.5)


def test_read_images(tmp_path, ray_start_regular):
    from PIL import Image
    rng = np.random.default_rng(0)
    for i in range(4):
        arr = rng.integers(0, 255, (24, 32, 3), np.uint8)
        Image.fromarray(arr).save(tmp_path / f"img{i}.png")
    ds = rdata.read_images(str(tmp_path))
    assert ds.count() == 4
    rows = ds.take_all()
    assert rows[0]["image"].shape == (24, 32, 3)
    assert rows[0]["image"].dtype == np.uint8
    # Resize + grayscale + paths.
    ds2 = rdata.read_images(str(tmp_path), size=(8, 16), mode="L",
                            include_paths=True)
    row = ds2.take_all()[0]
    assert row["image"].shape == (8, 16)
    assert row["path"].endswith(".png")

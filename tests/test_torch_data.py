"""The port's data plane (`ray_tpu_torch.data`, a copy of `ray_tpu.data`)
against the reference's, after `tests/test_data.py`,
`test_data_readers.py`, `test_data_streaming.py` and
`test_data_transport.py`: the same seeded numpy pipelines through both give
the same rows, in the same order where the plan fixes one. The port runs in
a cluster on this machine (map tasks in forked CPU workers, exchanges over
the block transport), the reference in local mode beside it, both up for
the module.

Also: the transport's rungs on the port (no silent `get` on a streaming
run, a remote bundle over the span rung, the exchange with the transport on
and off); `StreamingIngest`'s gap-free epochs and backpressure;
`session.get_streaming_ingest` inside a port `TorchTrainer` given
`datasets=` (it returns a `StreamingIngest` and the rank's rows in order,
as the reference's does); and, in a subprocess where pandas and pyarrow
cannot be imported, `import ray_tpu_torch.data` with the numpy, items and
range paths running."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as rdata
import ray_tpu_torch as rt
import ray_tpu_torch.data as tdata
from ray_tpu_torch.core import bulk as bulk_mod
from ray_tpu_torch.core import config as rt_config
from ray_tpu_torch.data import streaming, transport

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    rt.init(num_cpus=4)
    ray_tpu.init(local_mode=True)
    try:
        yield
    finally:
        ray_tpu.shutdown()
        rt.shutdown()
        rt_config._reset_cache_for_tests()


def _norm(rows):
    """Rows as comparable values: a dict row becomes its (column, value)
    pairs in column order, each value a plain Python value."""
    out = []
    for r in rows:
        if isinstance(r, dict):
            out.append(tuple((k, np.asarray(v).tolist()) for k, v in sorted(r.items())))
        else:
            out.append(np.asarray(r).tolist())
    return out


def _mk(d, n=2000, parallelism=6):
    return d.range(n, parallelism=parallelism).map_batches(
        lambda b: {"id": b["id"], "v": b["id"].astype(np.float64) * 0.5, "k": (b["id"] % 5).astype(np.int64),
                   "emb": np.stack([b["id"], b["id"] + 1], axis=1).astype(np.float32)})


_PERM = np.random.default_rng(0).permutation(200)
_ITEMS = [{"k": i % 3, "v": float(i), "label": "pos" if i % 2 else "neg"} for i in range(30)]


def _scaled(d):
    ds = d.from_items(_ITEMS)
    out = []
    for pre in (d.StandardScaler(["v"]), d.MinMaxScaler(["v"]), d.LabelEncoder("label"),
                d.Concatenator(["k", "v"], output_column_name="feat")):
        fitted = pre.fit(ds) if hasattr(pre, "fit") else pre
        out += fitted.transform(ds).take_all()
    return out


# Each pipeline takes the data module (the port's or the reference's) and
# returns rows; `ordered` pipelines are compared in order, the others as
# multisets.
PIPELINES = {
    "map_filter_shuffle": (True, lambda d: _mk(d).filter(lambda r: r["id"] % 3 != 0)
                           .random_shuffle(seed=7).take_all()),
    "map_rebatched": (True, lambda d: d.range(50, parallelism=2).map_batches(
        lambda b: {"n": np.asarray([len(b["id"])]), "first": b["id"][:1]}, batch_size=16).take_all()),
    "map_flat_map_limit": (True, lambda d: d.from_items([{"v": i} for i in range(20)]).flat_map(
        lambda r: [{"v": r["v"]}, {"v": r["v"] * 10}]).limit(25).take_all()),
    "columns": (True, lambda d: d.range(8).add_column("y", lambda b: b["id"] * 3)
                .rename_columns({"id": "idx"}).drop_columns(["idx"]).take_all()),
    "range_tensor": (True, lambda d: d.range_tensor(12, shape=(2, 3), parallelism=3).take_all()),
    "sort": (True, lambda d: d.from_numpy(_PERM, column="v").sort("v", descending=True).take_all()),
    "sort_exchange": (True, lambda d: _mk(d, 3000, 5).sort("v").take(50)),
    "groupby_aggregate": (False, lambda d: d.from_items(_ITEMS).groupby("k").aggregate(
        d.Sum("v"), d.Mean("v"), d.Max("v"), d.Count()).take_all()),
    "groupby_exchange": (False, lambda d: _mk(d, 3000, 6).groupby("k").sum("v").take_all()),
    "map_groups": (False, lambda d: d.from_items(_ITEMS).groupby("k").map_groups(
        lambda b: {"k": b["k"][:1], "vmax": np.asarray([b["v"].max()])}).take_all()),
    "repartition": (False, lambda d: _mk(d, 1000, 10).repartition(3).take_all()),
    "zip_union": (True, lambda d: d.range(10).zip(d.range(10).map_batches(lambda b: {"sq": b["id"] ** 2}))
                  .union(d.range(4).map_batches(lambda b: {"id": b["id"], "sq": -b["id"]})).take_all()),
    "split": (True, lambda d: [p.take_all() for p in d.range(100, parallelism=10).split(3)]),
    "split_equal": (True, lambda d: [p.take_all() for p in d.range(90, parallelism=9).split(3, equal=True)]),
    "split_at_indices": (True, lambda d: [p.take_all() for p in d.range(10).split_at_indices([3, 7])]),
    "train_test_split": (True, lambda d: [p.take_all() for p in d.range(100, parallelism=4).train_test_split(
        0.25, shuffle=True, seed=3)]),
    "streaming_split": (True, lambda d: [list(it.iter_rows()) for it in _mk(d, 600, 6).streaming_split(2)]),
    "random_sample": (True, lambda d: d.range(1000, parallelism=4).random_sample(0.1, seed=3).take_all()),
    "local_shuffle": (True, lambda d: [b["id"].tolist() for b in d.range(40, parallelism=4).iter_batches(
        batch_size=10, local_shuffle_buffer_size=20, local_shuffle_seed=5, prefetch_batches=0)]),
    "preprocessors": (True, _scaled),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipeline_equals_the_references(name):
    ordered, pipeline = PIPELINES[name]
    got, want = pipeline(tdata), pipeline(rdata)
    if name.startswith("split") or name in ("train_test_split", "streaming_split"):
        got, want = [_norm(p) for p in got], [_norm(p) for p in want]
        assert [len(p) for p in got] == [len(p) for p in want] and all(got), [len(p) for p in got]
    else:
        got, want = _norm(got), _norm(want)
        assert len(got) > 0
    if not ordered:
        got, want = sorted(got), sorted(want)
    assert got == want


def test_stats_and_schema_equal_the_references():
    for d in (tdata, rdata):
        ds = d.range(10)
        assert ds.schema() == {"id": ("int64", ())}
        assert ds.mean("id") == 4.5 and ds.count() == 10
    assert tdata.range(10).std("id") == rdata.range(10).std("id")
    assert tdata.from_items([{"v": 1}, {"v": 1}, {"v": 2}]).unique("v") == [1, 2]


def test_iter_torch_batches_equal_the_references():
    import torch

    got = list(tdata.range_tensor(20, shape=(3,)).iter_torch_batches(batch_size=8, dtypes=torch.float32,
                                                                     device="cpu"))
    want = list(rdata.range_tensor(20, shape=(3,)).iter_torch_batches(batch_size=8, dtypes=torch.float32))
    assert [b["data"].shape for b in got] == [(8, 3), (8, 3), (4, 3)]
    assert all(g["data"].dtype == torch.float32 and torch.equal(g["data"], w["data"]) for g, w in zip(got, want))
    assert not hasattr(tdata.DataIterator, "iter_jax_batches") and not hasattr(tdata.Dataset, "iter_jax_batches")


@pytest.mark.parametrize("fmt", ["numpy", "parquet", "csv"])
def test_readers_equal_the_references(fmt, tmp_path):
    """Each side writes the same dataset; each reads both directories."""
    def make(d):
        ds = d.range(40, parallelism=4).add_column("x", lambda b: b["id"] * 1.5)
        return ds.select_columns(["x"]) if fmt == "numpy" else ds

    readers = {"numpy": "read_numpy", "parquet": "read_parquet", "csv": "read_csv"}
    for side, d in (("port", tdata), ("ref", rdata)):
        getattr(make(d), f"write_{fmt}")(str(tmp_path / side))
    for side in ("port", "ref"):
        got = getattr(tdata, readers[fmt])(str(tmp_path / side)).take_all()
        want = getattr(rdata, readers[fmt])(str(tmp_path / side)).take_all()
        assert len(got) == 40 and sorted(_norm(got)) == sorted(_norm(want)), side


# ----------------------------------------------------------------- transport
def test_streaming_run_rides_the_transport_rungs():
    """read → segment bundles → chained map → shuffle exchange → driver: the
    rung ledger shows arena/inline traffic and no silent `get`, and the rows
    equal the reference's permutation."""
    transport.reset_fetch_stats()
    ds = _mk(tdata, 6000, 4).materialize().map_batches(lambda b: {"id": b["id"], "v": b["v"]}).random_shuffle(seed=3)
    rows = ds.take_all()
    want = _mk(rdata, 6000, 4).materialize().map_batches(lambda b: {"id": b["id"], "v": b["v"]}) \
        .random_shuffle(seed=3).take_all()
    assert [r["id"] for r in rows] == [r["id"] for r in want]
    ledger = dict(streaming.last_run_stats().fetch)
    transport.merge_fetch_stats(ledger, transport.fetch_stats())
    assert ledger.get("get", 0) == 0, f"silent get fallback: {ledger}"
    assert ledger.get("local", 0) + ledger.get("inline", 0) > 0, ledger


def test_remote_bundle_rides_the_span_rung(monkeypatch):
    blocks = [{"a": np.arange(60_000, dtype=np.int64), "b": np.ones((60_000, 2), np.float32)}]
    desc = transport.put_bundle(blocks)
    assert transport.is_descriptor(desc) and not desc.get("inline")
    monkeypatch.setattr(bulk_mod, "_local_addrs", lambda: set())
    with transport.track_fetch() as f:
        got = transport.fetch_bundle(dict(desc, name=None))
    for k in blocks[0]:
        np.testing.assert_array_equal(got[0][k], blocks[0][k])
    assert f["span"] == 1 and f["get"] == 0 and f["cross_node_bytes"] == f["span_bytes"] > 0


@pytest.mark.parametrize("flag", ["1", "0"])
def test_exchange_with_and_without_the_transport(flag, monkeypatch):
    monkeypatch.setenv("RAY_TPU_DATA_BLOCK_TRANSPORT", flag)
    rt_config._reset_cache_for_tests()
    try:
        got = [r["id"] for r in _mk(tdata, 3000, 6).random_shuffle(seed=11).take_all()]
    finally:
        monkeypatch.delenv("RAY_TPU_DATA_BLOCK_TRANSPORT")
        rt_config._reset_cache_for_tests()
    assert got == [r["id"] for r in _mk(rdata, 3000, 6).random_shuffle(seed=11).take_all()]


# ------------------------------------------------------------- ingest
def test_ingest_epochs_are_gap_free_and_match_the_references():
    from ray_tpu.data.streaming import StreamingIngest as RefIngest

    with tdata.StreamingIngest(_mk(tdata, 200, 4), 50, epochs=3, prefetch=8) as ing:
        got = [b["id"].tolist() for b in ing]
        assert ing.batches_consumed == 12
    with RefIngest(_mk(rdata, 200, 4), 50, epochs=3, prefetch=8) as ref:
        want = [b["id"].tolist() for b in ref]
    assert got == want and sorted(i for b in got for i in b) == sorted(list(range(200)) * 3)


def test_ingest_backpressure_parks_the_producer():
    with tdata.StreamingIngest(_mk(tdata, 2000, 8), 100, epochs=1, prefetch=2) as ing:
        time.sleep(1.0)
        s = ing.stats()
        assert s["queue_depth"] <= s["queue_cap"] == 2 and s["batches_produced"] <= 3
        total = 0
        for b in ing:
            total += len(b["id"])
            time.sleep(0.02)
    assert total == 2000 and ing.backpressure_s > 0.0, ing.stats()


def _ingest_loop(package: str):
    """A train loop (a closure: workers cannot import this module) that
    takes three batches through `session.get_streaming_ingest` and shuts
    the ingest down mid-epoch."""

    def loop(config):
        import importlib

        session = importlib.import_module(f"{package}.train.session")
        streaming = importlib.import_module(f"{package}.data.streaming")
        with session.get_streaming_ingest("train", batch_size=10) as ing:
            kind = type(ing).__name__, isinstance(ing, streaming.StreamingIngest)
            ids = [ing.next_batch()["id"].tolist() for _ in range(3)]
            stats = ing.stats()
        session.report({"kind": kind, "ids": ids, "produced": stats["batches_produced"],
                        "missing": session.get_streaming_ingest("nope") is None})

    return loop


def test_get_streaming_ingest_inside_a_torch_trainer(tmp_path):
    """The port's trainer hands its worker the rank's shard; the session
    wraps it in a StreamingIngest (it raised ModuleNotFoundError before the
    data plane was ported) and yields the rows the reference's does."""
    from ray_tpu.train import DataParallelTrainer as RefTrainer
    from ray_tpu.train import RunConfig as RefRunConfig
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    result = TorchTrainer(_ingest_loop("ray_tpu_torch"), datasets={"train": _mk(tdata, 200, 4)},
                          scaling_config=ScalingConfig(num_workers=1),
                          run_config=RunConfig(storage_path=str(tmp_path / "port"))).fit()
    assert result.error is None, result.error
    ref = RefTrainer(_ingest_loop("ray_tpu"), datasets={"train": _mk(rdata, 200, 4)},
                     run_config=RefRunConfig(storage_path=str(tmp_path / "ref"))).fit()
    assert ref.error is None, ref.error
    got, want = result.metrics, ref.metrics
    assert tuple(got["kind"]) == ("StreamingIngest", True) and got["missing"]
    assert got["ids"] == want["ids"] == [list(range(i, i + 10)) for i in (0, 10, 20)]
    assert 3 <= got["produced"] < 20


# ------------------------------------------------------- without pandas
def test_imports_and_runs_without_pandas_or_pyarrow():
    """The card's machine has neither: importing the data plane must not
    need them, the numpy, items and range paths run (local mode), and a
    pandas-backed reader raises ImportError when called."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['pyarrow'] = None\n"
        "import numpy as np\n"
        "import ray_tpu_torch as rt\n"
        "import ray_tpu_torch.data as d\n"
        "rt.init(local_mode=True)\n"
        "assert d.range(10).map_batches(lambda b: {'id': b['id'] * 2}).sum('id') == 90\n"
        "assert d.range_tensor(4, shape=(2,)).take_batch(4)['data'].shape == (4, 2)\n"
        "assert sorted(d.from_items([3, 1, 2]).take_all()) == [1, 2, 3]\n"
        "assert d.from_numpy(np.arange(6).reshape(3, 2), column='x').count() == 3\n"
        "assert len(list(d.range(8).iter_torch_batches(batch_size=4, device='cpu'))) == 2\n"
        "try:\n"
        "    d.from_pandas([])\n"
        "    raise SystemExit('from_pandas ran without pandas')\n"
        "except ImportError:\n"
        "    pass\n"
        "rt.shutdown()\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**env, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]

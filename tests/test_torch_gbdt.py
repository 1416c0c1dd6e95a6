"""The port's GBDT booster and trainers (`ray_tpu_torch/models/gbdt.py`,
`ray_tpu_torch/train/gbdt_trainer.py`) against the JAX reference's, on the
reference test's data (`tests/test_gbdt.py:14-28`): the same numpy inputs
through both give the same trees (feature, threshold and leaf mask equal,
leaf values within a stated tolerance), the same loss history, and a
JAX-fitted model predicts the same through the port's `from_dict`.

Trees compare exactly because the port sums the bin cumsums in XLA's order
(`_cumsum_bins`); the fits' leaf values and predictions drift only by the
f32 rounding of the two libraries' reductions (`g.sum()`), which the
tolerances below state. Leaf values are compared where a sample can land (a
node whose ancestors all split): a node below a leaf holds the value of an
argmax over gains that are all invalid or below zero, which no prediction
reads."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ray_tpu_torch as rt
import ray_tpu_torch.data as tdata
from ray_tpu.models import gbdt as ref
from ray_tpu_torch.models import gbdt as port
from ray_tpu_torch.train import GBDTTrainer, RunConfig, ScalingConfig, XGBoostTrainer

LEAF_TOL = 1e-5        # one tree from the same g, h: |d| <= tol·(1 + |ref|)
FIT_LEAF_TOL = 1e-4    # after a whole fit (the preds drift by f32 rounding)
HISTORY_TOL = 1e-5
PREDICT_TOL = 1e-6


def _regression_data(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 5)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + (X[:, 1] > 0.3) * 2.0 + 0.5 * X[:, 2] ** 2
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    return X, y


def _classification_data(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    y = ((X[:, 0] * X[:, 1] > 0) ^ (X[:, 2] > 1.0)).astype(np.float32)
    return X, y


# The reference test's fits (`tests/test_gbdt.py:33-52`).
FITS = {
    "regression": (_regression_data, dict(num_boost_round=40, max_depth=4, learning_rate=0.2)),
    "classification": (_classification_data, dict(objective="binary_logistic", num_boost_round=60,
                                                   max_depth=4, learning_rate=0.3)),
}


def _reachable(is_leaf: np.ndarray) -> np.ndarray:
    """[..., nodes] mask of the nodes a sample can reach."""
    out = np.zeros_like(is_leaf)
    out[..., 0] = True
    for n in range(is_leaf.shape[-1]):
        for c in (2 * n + 1, 2 * n + 2):
            if c < is_leaf.shape[-1]:
                out[..., c] = out[..., n] & ~is_leaf[..., n]
    return out


def _assert_trees_equal(got: dict, want: dict, leaf_tol: float):
    for k in ("feat", "thresh", "is_leaf"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    at = _reachable(np.asarray(want["is_leaf"]))
    g, w = np.asarray(got["leaf"])[at], np.asarray(want["leaf"])[at]
    assert np.all(np.abs(g - w) <= leaf_tol * (1 + np.abs(w))), np.abs(g - w).max()


def _grad_hess_inputs(X, y, objective, seed=3):
    rng = np.random.default_rng(seed)
    pred = (0.3 * rng.standard_normal(len(y))).astype(np.float32)
    if objective == "squared_error":
        return pred - y, np.ones_like(y)
    p = 1 / (1 + np.exp(-pred.astype(np.float64)))
    return (p - y).astype(np.float32), (p * (1 - p)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(FITS))
def test_grow_tree_equals_the_references(name):
    data, prm = FITS[name]
    X, y = data()
    params = port.GBDTParams(**prm)
    edges = port.quantile_bins(X, params.max_bins)
    np.testing.assert_array_equal(edges, ref.quantile_bins(X, params.max_bins))
    bins = port.apply_bins(X, edges)
    np.testing.assert_array_equal(bins, ref.apply_bins(X, edges))
    g, h = _grad_hess_inputs(X, y, params.objective)
    want = ref._grow_tree(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), params.max_depth,
                          params.max_bins, params.reg_lambda, params.gamma, params.min_child_weight)
    got = port._grow_tree(torch.from_numpy(bins).long(), torch.from_numpy(g), torch.from_numpy(h),
                          params.max_depth, params.max_bins, params.reg_lambda, params.gamma,
                          params.min_child_weight)
    keys = ("feat", "thresh", "leaf", "is_leaf")
    _assert_trees_equal({k: t.numpy() for k, t in zip(keys, got)},
                        {k: np.asarray(t) for k, t in zip(keys, want)}, LEAF_TOL)
    # And the tree predicts what the reference's predicts.
    p_want = ref._predict_tree(jnp.asarray(bins), *want, params.max_depth)
    p_got = port._predict_tree(torch.from_numpy(bins).long(), *got, params.max_depth)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_want), rtol=LEAF_TOL, atol=LEAF_TOL)


@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_equals_the_references(name):
    data, prm = FITS[name]
    X, y = data()
    want = ref.GradientBoostedTrees(ref.GBDTParams(**prm)).fit(X[:1600], y[:1600])
    got = port.GradientBoostedTrees(port.GBDTParams(**prm), device="cpu").fit(X[:1600], y[:1600])
    _assert_trees_equal(got.trees, want.trees, FIT_LEAF_TOL)
    for k in want.trees:
        assert got.trees[k].dtype == want.trees[k].dtype, k
    np.testing.assert_allclose(got.train_history, want.train_history, rtol=HISTORY_TOL, atol=HISTORY_TOL)
    # The reference test's gates hold for the port's fit too.
    if name == "regression":
        mse = float(np.mean((got.predict(X[1600:]) - y[1600:]) ** 2))
        assert mse < 0.25 * float(np.var(y[1600:]))
        assert got.train_history[-1] < 0.3 * got.train_history[0]
    else:
        proba = got.predict(X[1600:])
        assert float(((proba > 0.5) == y[1600:]).mean()) > 0.85
        assert proba.min() >= 0.0 and proba.max() <= 1.0


@pytest.mark.parametrize("name", sorted(FITS))
def test_a_jax_fitted_model_predicts_the_same_in_the_port(name):
    data, prm = FITS[name]
    X, y = data(800)
    jax_model = ref.GradientBoostedTrees(ref.GBDTParams(**{**prm, "num_boost_round": 10})).fit(X, y)
    loaded = port.GradientBoostedTrees.from_dict(jax_model.to_dict(), device="cpu")
    np.testing.assert_allclose(loaded.predict(X), jax_model.predict(X), rtol=PREDICT_TOL, atol=PREDICT_TOL)
    np.testing.assert_allclose(loaded.predict_raw(X), jax_model.predict_raw(X), rtol=PREDICT_TOL,
                               atol=PREDICT_TOL)
    # And back: the port's round trip.
    clone = port.GradientBoostedTrees.from_dict(loaded.to_dict(), device="cpu")
    np.testing.assert_array_equal(clone.predict(X), loaded.predict(X))


def test_empty_bins_resolve_ties_to_the_first_maximum():
    """A constant feature and few rows leave most bins empty: empty bins give
    exactly equal cumulative stats, hence equal gains, and both argmaxes take
    the first of them."""
    rng = np.random.default_rng(7)
    X = np.concatenate([np.full((40, 1), 2.5, np.float32), rng.standard_normal((40, 2)).astype(np.float32),
                        rng.integers(0, 3, (40, 1)).astype(np.float32)], axis=1)
    y = (X[:, 1] + (X[:, 3] == 1) + 0.1 * rng.standard_normal(40)).astype(np.float32)
    prm = dict(num_boost_round=5, max_depth=3, learning_rate=0.5, max_bins=64)
    want = ref.GradientBoostedTrees(ref.GBDTParams(**prm)).fit(X, y)
    got = port.GradientBoostedTrees(port.GBDTParams(**prm), device="cpu").fit(X, y)
    bins = port.apply_bins(X, got.edges)
    assert len(np.unique(bins[:, 0])) == 1 and len(np.unique(bins[:, 3])) == 3  # empty bins
    _assert_trees_equal(got.trees, want.trees, FIT_LEAF_TOL)
    # A split on the 3-valued feature sits at the first bin of its run of
    # tied gains: an occupied bin, never one of the empty bins after it.
    on_f3 = (got.trees["feat"] == 3) & ~got.trees["is_leaf"]
    assert on_f3.any()
    assert set(got.trees["thresh"][on_f3].tolist()) <= set(np.unique(bins[:, 3]).tolist())
    np.testing.assert_allclose(got.train_history, want.train_history, rtol=HISTORY_TOL, atol=HISTORY_TOL)


def test_uint8_bins_are_widened_before_indexing():
    bins = port._device_bins(np.array([[0, 255], [1, 2]], np.uint8), "cpu")
    assert bins.dtype == torch.int64 and bins.tolist() == [[0, 255], [1, 2]]


def test_max_bins_out_of_range_raises():
    with pytest.raises(ValueError, match="max_bins"):
        port.GradientBoostedTrees(port.GBDTParams(max_bins=300), device="cpu").fit(
            np.zeros((4, 1), np.float32), np.zeros(4, np.float32))


def test_booster_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _regression_data(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.GradientBoostedTrees(port.GBDTParams(num_boost_round=1)).fit(X, y)


# ------------------------------------------------------------------ trainers
@pytest.fixture(scope="module")
def local_port_runtime():
    rt.init(local_mode=True)
    try:
        yield
    finally:
        rt.shutdown()


def _ds(X, y, lo, hi, chunk=400):
    """Numpy blocks split into {"x", "y"} columns (the chip phase's build)."""
    rows = np.concatenate([X[lo:hi], y[lo:hi, None]], axis=1)
    chunks = [rows[i:i + chunk] for i in range(0, len(rows), chunk)]
    return tdata.from_numpy(chunks).map_batches(lambda b: {"x": b["data"][:, :-1], "y": b["data"][:, -1]})


def test_gbdt_trainer_equals_the_in_process_fit(local_port_runtime, tmp_path):
    X, y = _classification_data()
    params = port.GBDTParams(objective="binary_logistic", num_boost_round=40, max_depth=4, learning_rate=0.3)
    trainer = GBDTTrainer(
        datasets={"train": _ds(X, y, 0, 1600), "valid": _ds(X, y, 1600, 2000)},
        label_column="y", params=params,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["valid_accuracy"] > 0.8, result.metrics
    model = port.GradientBoostedTrees.from_dict(result.checkpoint.to_dict()["model"], device="cpu")
    in_process = port.GradientBoostedTrees(params, device="cpu").fit(X[:1600], y[:1600])
    for k in in_process.trees:
        np.testing.assert_array_equal(model.trees[k], in_process.trees[k], err_msg=k)
    assert model.trees["feat"].shape[0] == 40


def test_xgboost_trainer_param_map(local_port_runtime, tmp_path):
    X, y = _regression_data(800)
    trainer = XGBoostTrainer(
        datasets={"train": _ds(X, y, 0, 800)}, label_column="y",
        params={"objective": "reg:squarederror", "eta": 0.2, "max_depth": 4, "lambda": 1.0},
        num_boost_round=20, scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(storage_path=str(tmp_path)),
    )
    assert trainer.train_loop_config["gbdt_params"] == port.GBDTParams(
        objective="squared_error", num_boost_round=20, learning_rate=0.2, max_depth=4, reg_lambda=1.0)
    assert trainer.train_loop_config["device"] == "cpu"
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["train_loss"] < 0.5
    got = port.GradientBoostedTrees.from_dict(result.checkpoint.to_dict()["model"], device="cpu")
    in_process = port.GradientBoostedTrees(trainer.train_loop_config["gbdt_params"], device="cpu").fit(X, y)
    for k in in_process.trees:
        np.testing.assert_array_equal(got.trees[k], in_process.trees[k], err_msg=k)
    # The reference's fit of the same params: the same loss history (at these
    # rows one split of its 20 trees is an exact tie that f32 rounding breaks
    # the other way, so its trees are not compared).
    want = ref.GradientBoostedTrees(ref.GBDTParams(objective="squared_error", num_boost_round=20,
                                                   learning_rate=0.2, max_depth=4)).fit(X, y)
    np.testing.assert_allclose(got.train_history, want.train_history, rtol=HISTORY_TOL, atol=HISTORY_TOL)


def test_trainers_default_to_a_gpu_worker_and_reject_what_the_reference_rejects():
    trainer = GBDTTrainer(datasets={}, label_column="y")
    assert trainer.scaling_config.use_gpu and trainer.train_loop_config["device"] == "cuda"
    with pytest.raises(ValueError, match="unsupported xgboost param"):
        XGBoostTrainer(datasets={}, label_column="y",
                       params={"objective": "reg:squarederror", "colsample_bytree": 0.5})
    with pytest.raises(ValueError, match="not supported"):
        XGBoostTrainer(datasets={}, label_column="y", params={"objective": "multi:softmax"})

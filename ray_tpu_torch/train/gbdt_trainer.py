"""GBDT trainers over Ray Data.

Reference analog: `python/ray/train/gbdt_trainer.py` (shared base of
`XGBoostTrainer` / `LightGBMTrainer`, `train/xgboost/xgboost_trainer.py`) —
the reference schedules external C++ boosters across a worker gang. The
booster here is the port's (`models/gbdt.py` — histogram rounds in torch on
the worker's card; the JAX reference, `ray_tpu/train/gbdt_trainer.py:5-8`,
jits them), so the same trainer surface runs with no external
dependency. `XGBoostTrainer` is an API-compatibility shim that translates
common xgboost param names onto `GBDTParams`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..models.gbdt import GBDTParams, GradientBoostedTrees
from .checkpoint import Checkpoint
from .config import RunConfig, ScalingConfig
from .data_parallel_trainer import DataParallelTrainer


def _materialize_xy(shard, label_column: str):
    """Dataset shard -> (X, y) numpy (GBDT fits in-memory per worker, like
    the reference's DMatrix build)."""
    feats, labels = [], []
    for batch in shard.iter_batches(batch_size=4096, batch_format="numpy"):
        y = batch.pop(label_column)
        cols = [np.asarray(batch[k], np.float32).reshape(len(y), -1)
                for k in sorted(batch)]
        feats.append(np.concatenate(cols, axis=1))
        labels.append(np.asarray(y, np.float32).ravel())
    return np.concatenate(feats), np.concatenate(labels)


def _gbdt_loop(config: Dict[str, Any]):
    from .. import train

    shard = train.get_dataset_shard("train")
    X, y = _materialize_xy(shard, config["label_column"])
    # reference: `GradientBoostedTrees(config["gbdt_params"])` (JAX picks the
    # device); the port fits on the device the trainer chose for the worker.
    model = GradientBoostedTrees(config["gbdt_params"], device=config["device"]).fit(X, y)
    metrics = {"train_loss": model.train_history[-1],
               "num_trees": int(model.trees["feat"].shape[0])}
    valid = train.get_dataset_shard("valid")
    if valid is not None:
        Xv, yv = _materialize_xy(valid, config["label_column"])
        pred = model.predict(Xv)
        if config["gbdt_params"].objective == "squared_error":
            metrics["valid_rmse"] = float(np.sqrt(np.mean((pred - yv) ** 2)))
        else:
            metrics["valid_logloss"] = float(
                -np.mean(yv * np.log(pred + 1e-9)
                         + (1 - yv) * np.log(1 - pred + 1e-9))
            )
            metrics["valid_accuracy"] = float(((pred > 0.5) == yv).mean())
    train.report(metrics, checkpoint=Checkpoint.from_dict(
        {"model": model.to_dict()}
    ))


class GBDTTrainer(DataParallelTrainer):
    """Fit the histogram booster on a Ray Dataset (the reference's
    docstring, `ray_tpu/train/gbdt_trainer.py:63`, says a JAX one), on one
    GPU worker unless the `ScalingConfig` asks for CPU workers.

        trainer = GBDTTrainer(
            datasets={"train": ds, "valid": vds},
            label_column="y",
            params=GBDTParams(objective="binary_logistic", max_depth=5),
        )
        result = trainer.fit()
        model = GradientBoostedTrees.from_dict(
            result.checkpoint.to_dict()["model"])
    """

    def __init__(
        self,
        *,
        datasets,
        label_column: str,
        params: Optional[GBDTParams] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        # reference (`ray_tpu/train/gbdt_trainer.py:90`): ScalingConfig(num_workers=1).
        # The port fits on a GPU worker's card by default, as its
        # TransformersTrainer does; a caller's use_gpu=False asks for a CPU
        # worker, which sees no card, and the loop fits on the CPU there.
        scaling_config = scaling_config or ScalingConfig(num_workers=1, use_gpu=True)
        super().__init__(
            _gbdt_loop,
            train_loop_config={
                "label_column": label_column,
                "gbdt_params": params or GBDTParams(),
                "device": "cuda" if scaling_config.use_gpu else "cpu",  # reference: no device
            },
            scaling_config=scaling_config,  # reference: `scaling_config or ScalingConfig(num_workers=1)`
            run_config=run_config,
            datasets=datasets,
        )


_XGB_PARAM_MAP = {
    "eta": "learning_rate",
    "learning_rate": "learning_rate",
    "max_depth": "max_depth",
    "lambda": "reg_lambda",
    "reg_lambda": "reg_lambda",
    "gamma": "gamma",
    "min_child_weight": "min_child_weight",
    "base_score": "base_score",
    "max_bin": "max_bins",
}
_XGB_OBJECTIVES = {
    "reg:squarederror": "squared_error",
    "binary:logistic": "binary_logistic",
}


class XGBoostTrainer(GBDTTrainer):
    """xgboost-flavored surface (reference:
    `python/ray/train/xgboost/xgboost_trainer.py`) on the port's booster (the reference: the JAX one) —
    accepts the common subset of xgboost `params` plus
    `num_boost_round`."""

    def __init__(self, *, datasets, label_column: str,
                 params: Optional[Dict[str, Any]] = None,
                 num_boost_round: int = 50, **kw):
        params = dict(params or {})
        obj = params.pop("objective", "reg:squarederror")
        if obj not in _XGB_OBJECTIVES:
            raise ValueError(
                f"objective {obj!r} not supported (have: "
                f"{sorted(_XGB_OBJECTIVES)})"
            )
        mapped: Dict[str, Any] = {"objective": _XGB_OBJECTIVES[obj],
                                  "num_boost_round": num_boost_round}
        for k, v in params.items():
            if k not in _XGB_PARAM_MAP:
                raise ValueError(f"unsupported xgboost param {k!r}")
            mapped[_XGB_PARAM_MAP[k]] = v
        super().__init__(
            datasets=datasets, label_column=label_column,
            params=GBDTParams(**mapped), **kw,
        )

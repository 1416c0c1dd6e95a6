"""Fit/transform preprocessors (reference: `python/ray/data/preprocessor.py`
and `ray.data.preprocessors`)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Preprocessor:
    """Stateful transform: `fit` computes stats, `transform` applies them."""

    _is_fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._is_fitted = True
        return self

    def transform(self, ds):
        if not self._is_fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} must be fit before transform.")
        return ds.map_batches(self._transform_numpy, batch_format="numpy")

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self._transform_numpy(batch)

    def _needs_fit(self) -> bool:
        return True

    def _fit(self, ds):
        pass

    def _transform_numpy(self, batch):
        raise NotImplementedError


class StandardScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds):
        for c in self.columns:
            self.stats_[c] = (ds.mean(c), ds.std(c, ddof=0))

    def _transform_numpy(self, batch):
        out = dict(batch)
        for c in self.columns:
            mu, sd = self.stats_[c]
            out[c] = (batch[c] - mu) / (sd if sd else 1.0)
        return out


class MinMaxScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds):
        for c in self.columns:
            self.stats_[c] = (ds.min(c), ds.max(c))

    def _transform_numpy(self, batch):
        out = dict(batch)
        for c in self.columns:
            lo, hi = self.stats_[c]
            rng = (hi - lo) or 1.0
            out[c] = (batch[c] - lo) / rng
        return out


class LabelEncoder(Preprocessor):
    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: Optional[List] = None

    def _fit(self, ds):
        self.classes_ = ds.unique(self.label_column)

    def _transform_numpy(self, batch):
        out = dict(batch)
        lookup = {v: i for i, v in enumerate(self.classes_)}
        out[self.label_column] = np.asarray([lookup[v] for v in batch[self.label_column].tolist()])
        return out


class Concatenator(Preprocessor):
    """Concatenate numeric columns into one feature matrix column."""

    def __init__(self, columns: List[str], output_column_name: str = "concat_out", dtype=np.float32):
        self.columns = columns
        self.output_column_name = output_column_name
        self.dtype = dtype

    def _needs_fit(self):
        return False

    def _transform_numpy(self, batch):
        mats = [np.asarray(batch[c], dtype=self.dtype).reshape(len(batch[c]), -1) for c in self.columns]
        out = {k: v for k, v in batch.items() if k not in self.columns}
        out[self.output_column_name] = np.concatenate(mats, axis=1)
        return out

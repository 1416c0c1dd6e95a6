"""Gradient-boosted decision trees on torch tensors.

Reference analog: `python/ray/train/gbdt_trainer.py` + the xgboost/lightgbm
trainers built on it — the reference delegates the math to external C++
boosters. The port keeps the JAX reference's design (`ray_tpu/models/gbdt.py`)
op for op on the tensors' device: features are quantile-binned to uint8
once on the host; each round computes gradients, builds [node, feature,
bin] histograms by a scatter-add, picks splits by vectorized gain, and
routes samples — no per-node Python, no dynamic shapes. Trees are complete
binary trees in array form (feature/threshold/leaf-value per node), so
prediction is D vectorized gathers.

The histogram sums each bin in row order on either device (`_histograms`:
a sort-based `index_put_(accumulate=True)` on CUDA, a serial `index_add_`
on the CPU), so two fits of the same data give the same trees bit for bit
(a float scatter-add by atomics adds in whatever order the threads arrive,
and a near-tie split can flip).

Supports squared-error regression and binary logistic classification —
the two objectives the reference's release tests gate
(`release/train_tests/xgboost_lightgbm`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device


@dataclass
class GBDTParams:
    objective: str = "squared_error"   # squared_error | binary_logistic
    num_boost_round: int = 50
    max_depth: int = 4
    learning_rate: float = 0.1
    reg_lambda: float = 1.0            # L2 on leaf values
    gamma: float = 0.0                 # min split gain
    min_child_weight: float = 1.0      # min hessian sum per child
    max_bins: int = 256                # uint8 binning
    base_score: float = 0.0


def quantile_bins(X: np.ndarray, max_bins: int = 256) -> np.ndarray:
    """Per-feature quantile cut points [F, max_bins-1] (host-side, once)."""
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    return np.quantile(X, qs, axis=0).T.astype(np.float32)  # [F, B-1]


def apply_bins(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """float features -> uint8 bin indices via the stored cut points."""
    out = np.empty(X.shape, np.uint8)
    for f in range(X.shape[1]):
        out[:, f] = np.searchsorted(edges[f], X[:, f], side="left")
    return out


def _grad_hess(objective: str, pred, y):
    if objective == "squared_error":
        return pred - y, torch.ones_like(pred)
    if objective in ("binary_logistic", "binary:logistic"):
        # The sigmoid in f64, rounded once to f32 (the reference: XLA's f32
        # sigmoid, `gbdt.py:61`): the same f32 on the card and the CPU, whose
        # f32 sigmoids differ in the last bit. A node's sums are f32 values
        # of up to the row count; one bit of g moves their rounding, and a
        # right child (its parent's sum minus its sibling's) carries that
        # into leaf values at 1e-4.
        p = torch.sigmoid(pred.to(torch.float64)).to(torch.float32)
        return p - y, p * (1.0 - p)
    raise ValueError(f"unknown objective {objective!r}")


def _histograms(seg, g, h, num_seg: int):
    """Per-segment sums of g and h over the [N, F] segment ids `seg` (int64;
    g and h [N] f32, zero for samples off the level), each segment summed in
    row order (reference: two `jax.ops.segment_sum`, `gbdt.py:98-105`). On
    CUDA one `index_put_(accumulate=True)` of the [N·F, 2] rows: it sorts the
    ids stably and sums each id's rows in turn, where a float `index_add_`
    there adds by atomics in no fixed order. On the CPU `index_put_`
    accumulates in parallel in no fixed order and a 1-D `index_add_` runs
    serially, so the CPU takes that."""
    N, Fn = seg.shape
    ids = seg.reshape(-1)
    if g.device.type != "cuda":
        out_g = torch.zeros((num_seg,), dtype=g.dtype, device=g.device)
        out_h = torch.zeros((num_seg,), dtype=h.dtype, device=h.device)
        out_g.index_add_(0, ids, g[:, None].expand(N, Fn).reshape(-1))
        out_h.index_add_(0, ids, h[:, None].expand(N, Fn).reshape(-1))
        return out_g, out_h
    vals = torch.stack([g, h], dim=1)[:, None, :].expand(N, Fn, 2).reshape(N * Fn, 2)
    out = torch.zeros((num_seg, 2), dtype=g.dtype, device=g.device)
    out.index_put_((ids,), vals, accumulate=True)
    return out[:, 0], out[:, 1]


def _cumsum_bins(x, base: int = 16):
    """Cumulative sum over the last axis in the reference's order: XLA
    (`jnp.cumsum`, `gbdt.py:108-109`) scans in tiles of 16, each summed left
    to right in f32, plus the running total of the tiles before it. A float
    sum in another order can turn an exact tie of two gains (two splits that
    cut a node into the same halves) into a different argmax."""
    n = x.shape[-1]
    if n <= base:
        out = torch.empty_like(x)
        s = out[..., 0] = x[..., 0]
        for i in range(1, n):
            s = out[..., i] = s + x[..., i]
        return out
    tiles = F.pad(x, (0, (-n) % base)).reshape(*x.shape[:-1], -1, base)
    within = _cumsum_bins(tiles, base)
    total = _cumsum_bins(within[..., -1], base)
    before = torch.cat([torch.zeros_like(total[..., :1]), total[..., :-1]], dim=-1)
    return (within + before[..., None]).reshape(*x.shape[:-1], -1)[..., :n]


def _grow_tree(bins, g, h, depth: int, n_bins: int, reg_lambda, gamma,
               min_child_weight):
    """One tree on binned features. bins [N, F] int64 (indices; never index
    with a uint8 tensor: torch reads it as a mask); g,h [N] f32.
    Returns (feature, threshold, leaf_value, is_leaf) tensors sized for the
    complete binary tree of `depth` (2^(depth+1)-1 nodes)."""
    N, Fn = bins.shape
    dev = g.device
    n_nodes_total = 2 ** (depth + 1) - 1
    feat = torch.zeros((n_nodes_total,), dtype=torch.int64, device=dev)
    thresh = torch.zeros((n_nodes_total,), dtype=torch.int64, device=dev)
    is_leaf = torch.ones((n_nodes_total,), dtype=torch.bool, device=dev)
    node_g = torch.zeros((n_nodes_total,), dtype=torch.float32, device=dev)
    node_h = torch.zeros((n_nodes_total,), dtype=torch.float32, device=dev)
    # The root's sums in f64, rounded once (the reference: f32 sums in XLA's
    # order, `gbdt.py:79-80`): the same f32 on the card and the CPU. A right
    # child's sums are its parent's minus its sibling's, so a rounding in the
    # root's sum would reach every right child, amplified where the two
    # nearly cancel.
    node_g[0] = g.sum(dtype=torch.float64)
    node_h[0] = h.sum(dtype=torch.float64)

    assign = torch.zeros((N,), dtype=torch.int64, device=dev)  # tree-node index per sample
    f_idx = torch.arange(Fn, dtype=torch.int64, device=dev)[None, :]

    for d in range(depth):
        first, n_level = 2 ** d - 1, 2 ** d
        # Histograms for this level: local node id × feature × bin.
        local = assign - first  # [-] samples not at this level get clamped
        at_level = (assign >= first) & (assign < first + n_level)
        local = local.clamp(0, n_level - 1)
        seg = local[:, None] * (Fn * n_bins) + f_idx * n_bins + bins  # [N, F]
        w = at_level.to(torch.float32)
        num_seg = n_level * Fn * n_bins
        with torch.profiler.record_function("gbdt_hist"):
            hist_g, hist_h = _histograms(seg, g * w, h * w, num_seg)
        hist_g = hist_g.reshape(n_level, Fn, n_bins)
        hist_h = hist_h.reshape(n_level, Fn, n_bins)

        # Split gain for "left = bin <= b": cumulative stats over bins.
        GL = _cumsum_bins(hist_g)
        HL = _cumsum_bins(hist_h)
        G = GL[..., -1:]
        H = HL[..., -1:]
        GR, HR = G - GL, H - HL
        gain = 0.5 * (
            GL**2 / (HL + reg_lambda)
            + GR**2 / (HR + reg_lambda)
            - G**2 / (H + reg_lambda)
        ) - gamma
        valid = (HL >= min_child_weight) & (HR >= min_child_weight)
        gain = torch.where(valid, gain, -torch.inf)
        # [n_level, F·n_bins] in this order: argmax returns the first maximum,
        # as jnp.argmax does, so an empty bin's tied gain resolves the same.
        flat = gain.reshape(n_level, Fn * n_bins)
        best = flat.argmax(dim=-1)
        best_gain = torch.gather(flat, -1, best[:, None])[:, 0]
        best_f = best // n_bins
        best_b = best % n_bins
        do_split = best_gain > 0.0

        node_ids = first + torch.arange(n_level, device=dev)
        feat[node_ids] = torch.where(do_split, best_f, 0)
        thresh[node_ids] = torch.where(do_split, best_b, 0)
        is_leaf[node_ids] = ~do_split

        # Child aggregates (for leaf values at the last level).
        lg = torch.gather(GL.reshape(n_level, -1), -1, (best_f * n_bins + best_b)[:, None])[:, 0]
        lh = torch.gather(HL.reshape(n_level, -1), -1, (best_f * n_bins + best_b)[:, None])[:, 0]
        left_ids, right_ids = 2 * node_ids + 1, 2 * node_ids + 2
        node_g[left_ids] = lg
        node_g[right_ids] = node_g[node_ids] - lg
        node_h[left_ids] = lh
        node_h[right_ids] = node_h[node_ids] - lh

        # Route samples whose node split.
        nf = feat[assign]
        nb = thresh[assign]
        sample_bin = torch.gather(bins, 1, nf[:, None])[:, 0]
        split_here = at_level & ~is_leaf[assign]
        assign = torch.where(
            split_here,
            torch.where(sample_bin <= nb, 2 * assign + 1, 2 * assign + 2),
            assign,
        )

    leaf_value = -node_g / (node_h + reg_lambda)
    return feat, thresh, leaf_value.to(torch.float32), is_leaf


def _predict_tree(bins, feat, thresh, leaf_value, is_leaf, depth: int):
    N = bins.shape[0]
    idx = torch.zeros((N,), dtype=torch.int64, device=bins.device)
    for _ in range(depth):
        nf = feat[idx]
        nb = thresh[idx]
        sample_bin = torch.gather(bins, 1, nf[:, None])[:, 0]
        nxt = torch.where(sample_bin <= nb, 2 * idx + 1, 2 * idx + 2)
        idx = torch.where(is_leaf[idx], idx, nxt)
    return leaf_value[idx]


@dataclass
class GradientBoostedTrees:
    """Fitted ensemble. `trees` holds stacked per-tree numpy arrays (the
    reference's dict: a JAX-fitted model loads through `from_dict`). Fits and
    predicts on `device` (None: the card)."""

    params: GBDTParams
    edges: np.ndarray = None               # [F, max_bins-1] bin cut points
    trees: Dict[str, np.ndarray] = field(default_factory=dict)
    train_history: List[float] = field(default_factory=list)
    device: Optional[str] = None

    def fit(self, X: np.ndarray, y: np.ndarray,
            eval_every: int = 10) -> "GradientBoostedTrees":
        p = self.params
        if not 2 <= p.max_bins <= 256:
            # Bin indices live in uint8 — beyond 256 they'd silently wrap.
            raise ValueError(f"max_bins must be in [2, 256], got {p.max_bins}")
        dev = resolve_device(self.device)
        X = np.asarray(X, np.float32)
        y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        self.edges = quantile_bins(X, p.max_bins)
        bins = _device_bins(apply_bins(X, self.edges), dev)
        pred = torch.full((X.shape[0],), p.base_score, dtype=torch.float32, device=dev)
        feats, threshs, leaves, leafmask = [], [], [], []
        losses = []
        for r in range(p.num_boost_round):
            g, h = _grad_hess(p.objective, pred, y)
            t = _grow_tree(
                bins, g, h, p.max_depth, p.max_bins,
                p.reg_lambda, p.gamma, p.min_child_weight,
            )
            pred = pred + p.learning_rate * _predict_tree(
                bins, *t, p.max_depth
            )
            feats.append(t[0]); threshs.append(t[1])
            leaves.append(t[2]); leafmask.append(t[3])
            if r % eval_every == 0 or r == p.num_boost_round - 1:
                losses.append(self._loss(pred, y))
        # One copy to the host for the whole fit (the reference's float() per
        # eval and np.asarray per tree each wait for the device).
        self.train_history.extend(torch.stack(losses).tolist())
        self.trees = {
            "feat": torch.stack(feats).to(torch.int32).cpu().numpy(),
            "thresh": torch.stack(threshs).to(torch.int32).cpu().numpy(),
            "leaf": torch.stack(leaves).cpu().numpy(),
            "is_leaf": torch.stack(leafmask).cpu().numpy(),
        }
        return self

    def _loss(self, pred, y):
        if self.params.objective == "squared_error":
            return torch.mean((pred - y) ** 2)
        ll = F.logsigmoid(pred) * y + F.logsigmoid(-pred) * (1 - y)
        return -ll.mean()

    def predict_raw(self, X: np.ndarray) -> np.ndarray:
        dev = resolve_device(self.device)
        bins = _device_bins(apply_bins(np.asarray(X, np.float32), self.edges), dev)
        pred = torch.full((X.shape[0],), self.params.base_score, dtype=torch.float32, device=dev)
        tree = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in self.trees.items()}
        for i in range(self.trees["feat"].shape[0]):
            pred = pred + self.params.learning_rate * _predict_tree(
                bins,
                tree["feat"][i].long(),
                tree["thresh"][i].long(),
                tree["leaf"][i],
                tree["is_leaf"][i],
                self.params.max_depth,
            )
        return pred.cpu().numpy()

    def predict(self, X: np.ndarray) -> np.ndarray:
        raw = self.predict_raw(X)
        if self.params.objective == "squared_error":
            return raw
        return 1.0 / (1.0 + np.exp(-raw))  # probabilities

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            "params": self.params.__dict__,
            "edges": self.edges,
            "trees": self.trees,
            "train_history": self.train_history,
        }

    @classmethod
    def from_dict(cls, d: dict, device: Optional[str] = None) -> "GradientBoostedTrees":
        m = cls(GBDTParams(**d["params"]), device=device)
        m.edges = d["edges"]
        m.trees = d["trees"]
        m.train_history = list(d.get("train_history", []))
        return m


def _device_bins(bins: np.ndarray, device) -> torch.Tensor:
    """uint8 bins [N, F] -> int64 indices on the device: copied as uint8 (an
    eighth of the bytes), widened there once."""
    return torch.from_numpy(bins).to(device).long()

"""Mixture-of-Experts layer: the counterpart of `ray_tpu/ops/moe.py`, in
plain PyTorch (the reference has no Pallas kernel here).

GShard/Switch routing as dense one-hot dispatch and combine tensors and
einsums, exactly as the reference: top-1 (Switch) and top-2 (GShard) gating
with capacity dropping and the Switch load-balancing auxiliary loss.

Expert parallelism. Under pjit the reference routes as if unsharded: the
capacity comes from the global token count and each token's buffer slot
from a cumulative count over the global token order. When `x` is a
DTensor, `moe_forward` runs per rank under `shard_fn`, with tokens split
over the "batch" axes (dp, fsdp) and experts over "ep", and keeps those
semantics: a rank's slots start after the tokens of the lower batch ranks
(an exclusive scan over an all-gather of the per-expert counts), the
second choices after every first choice, and the aux loss takes its means
over all tokens. Each rank builds [N_local, E, C] only; the expert inputs
of its own experts are summed over the batch ranks (each slot holds one
token), and each token's output over the ep ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from ..device import resolve_device, resolve_dtype


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2                  # 1 = Switch, 2 = GShard
    capacity_factor: float = 1.25
    d_model: int = 768
    d_ff: int = 3072
    aux_loss_weight: float = 0.01
    activation: str = "gelu"        # gelu | swiglu (adds w_gate per expert)
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        object.__setattr__(self, "dtype", resolve_dtype(self.dtype))

    def capacity(self, num_tokens: int) -> int:
        c = int(self.capacity_factor * num_tokens * self.top_k / self.num_experts)
        return max(c, 4)


def moe_init(cfg: MoEConfig, seed: Union[int, torch.Generator] = 0, device=None) -> Dict[str, torch.Tensor]:
    """Params (f32, normal std 0.02) with logical dims:
    w_router (embed, experts); w_in (experts, embed, mlp); w_out (experts, mlp, embed)."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(device=dev).manual_seed(seed)
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.d_ff

    def n(shape):
        return torch.randn(shape, generator=gen, device=dev).mul_(0.02)

    params = {"w_router": n((D, E)), "w_in": n((E, D, F_)), "w_out": n((E, F_, D))}
    if cfg.activation == "swiglu":
        params["w_gate"] = n((E, D, F_))
    return params


def _one_hot(idx, n: int):
    """f32 one-hot of idx over n classes; an index outside [0, n) gives a
    zero row, as `jax.nn.one_hot` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _one_hot_dispatch(gate_idx, probs, mask, capacity, num_experts, offset=None):
    """Build dispatch/combine slices for one routing choice.

    gate_idx [N] expert per token; mask [N] tokens still in play; offset
    [E] slots taken before these tokens (by other ranks' tokens);
    returns (dispatch [N, E, C] one-hot, gate_probs [N] prob of this choice,
    kept [N] capacity mask).
    """
    expert_mask = _one_hot(gate_idx, num_experts) * mask[:, None]
    # Position of each token within its expert's buffer (cumulative count).
    position = torch.cumsum(expert_mask, dim=0)
    if offset is not None:
        position = position + offset[None, :]
    position = (position * expert_mask).sum(dim=-1) - 1.0       # [N], -1 if masked
    kept = (position >= 0) & (position < capacity)
    pos_oh = _one_hot(position.long(), capacity)
    dispatch = expert_mask[:, :, None] * pos_oh[:, None, :] * kept[:, None, None]
    gate_probs = (probs * expert_mask).sum(dim=-1)
    return dispatch, gate_probs, kept


def _slots_before(counts, axis):
    """(slots the lower ranks of `axis` take per expert, all ranks' total):
    an exclusive scan over an all-gather of the per-expert counts."""
    if axis is None:
        return None, counts
    from ..collective.ops import all_gather, axis_index

    every = all_gather(counts, axis, tiled=False)                 # [R, E]
    return every[:axis_index(axis)].sum(dim=0), every.sum(dim=0)


def moe_router(x_flat, w_router, cfg: MoEConfig, axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_flat [N, D] → (combine [N, E, C], aux_loss scalar).

    combine holds the gating weight of each (token, expert, slot); dispatch
    is its boolean support. With `axis` (under shard_fn) x_flat is this
    rank's block of the tokens split over `axis`, in rank order: capacity,
    slots and the aux loss are those of all the tokens."""
    from ..collective.ops import axis_size, psum

    N = x_flat.shape[0] * (axis_size(axis) if axis is not None else 1)
    E = cfg.num_experts
    C = cfg.capacity(N)
    logits = x_flat.float() @ w_router.float()       # router math in f32
    probs = torch.softmax(logits, dim=-1)            # [N, E]

    gate1 = probs.argmax(dim=-1)
    first = _one_hot(gate1, E)
    before1, first_counts = _slots_before(first.sum(dim=0), axis)
    disp1, p1, kept1 = _one_hot_dispatch(gate1, probs, torch.ones_like(probs[:, 0]), C, E, before1)

    # Load-balancing aux loss (Switch eq. 4): E * Σ_e f_e · P_e
    if axis is None:
        me, pe = first.mean(dim=0), probs.mean(dim=0)   # token fraction, mean router prob
    else:
        me, pe = first_counts / N, psum(probs.sum(dim=0), axis) / N
    aux = E * torch.sum(me * pe)

    if cfg.top_k == 1:
        return disp1 * p1[:, None, None], aux

    # Top-2: mask out the first choice, route the remainder.
    gate2 = (probs * (1.0 - first)).argmax(dim=-1)
    # Second-choice buffer positions start after all first-choice tokens.
    expert_mask2 = _one_hot(gate2, E)
    before2, _ = _slots_before(expert_mask2.sum(dim=0), axis)
    offset2 = first_counts if before2 is None else first_counts + before2
    disp2, p2, kept2 = _one_hot_dispatch(gate2, probs, torch.ones_like(p1), C, E, offset2)

    # Renormalize the two gate probs over the kept choices.
    denom = torch.clamp(p1 * kept1 + p2 * kept2, min=1e-9)
    combine = disp1 * (p1 * kept1 / denom)[:, None, None] + disp2 * (p2 * kept2 / denom)[:, None, None]
    return combine, aux


def _experts(params, x_flat, cfg: MoEConfig, token_axis=None, expert_axis=None):
    """y [N, D] and the aux loss for tokens x_flat; with the axes, the
    expert-parallel body (see the module docstring)."""
    from ..collective.ops import axis_index, psum

    combine, aux = moe_router(x_flat, params["w_router"], cfg, token_axis)
    combine = combine.to(cfg.dtype)
    if expert_axis is not None:  # this rank's experts only
        n_local = params["w_in"].shape[0]
        e0 = axis_index(expert_axis) * n_local
        combine = combine[:, e0:e0 + n_local]
    dispatch = (combine > 0).to(cfg.dtype)

    xc = x_flat.to(cfg.dtype)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, xc)         # [E, C, D]
    if token_axis is not None:
        expert_in = psum(expert_in, token_axis)
    h = torch.einsum("ecd,edf->ecf", expert_in, params["w_in"].to(cfg.dtype))
    if cfg.activation == "swiglu":
        g = torch.einsum("ecd,edf->ecf", expert_in, params["w_gate"].to(cfg.dtype))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu defaults to the tanh form
    expert_out = torch.einsum("ecf,efd->ecd", h, params["w_out"].to(cfg.dtype))
    y = torch.einsum("nec,ecd->nd", combine, expert_out)          # [N, D]
    if expert_axis is not None:
        y = psum(y, expert_axis)
    return y, aux


def moe_forward(params, x, cfg: MoEConfig, token_axis=None, expert_axis=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] → (y [..., D], aux_loss).

    Expert parallel, two ways: a DTensor x runs per rank on its mesh (tokens
    over the "batch" axes along dim 0, experts over "ep"; the params plain
    or DTensors); under shard_fn, `token_axis` names the axes x's tokens
    are split over (in rank order) and `expert_axis` the axes `params`'
    experts are split over. Either way y and aux equal the unsharded
    layer's."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _moe_expert_parallel(params, x, cfg)
    orig_shape = x.shape
    y, aux = _experts(params, x.reshape(-1, orig_shape[-1]), cfg, token_axis, expert_axis)
    return y.reshape(orig_shape), cfg.aux_loss_weight * aux


def _moe_expert_parallel(params, x, cfg: MoEConfig):
    from ..parallel.mesh import P, ShardingRules
    from ..parallel.spmd import shard_fn

    rules = ShardingRules.default()
    batch, experts = rules.spec("batch")[0], rules.spec("experts")[0]
    x_spec = P(batch, *([None] * (x.dim() - 1)))
    w_specs = {k: (P() if k == "w_router" else P(experts)) for k in params}

    def body(p, x_local):
        return moe_forward(p, x_local, cfg, batch, experts)

    return shard_fn(body, x.device_mesh, (w_specs, x_spec), (x_spec, P()))(params, x)


MOE_LOGICAL_DIMS = {
    "w_router": ("embed", "experts"),
    "w_in": ("experts", "embed", "mlp"),
    "w_out": ("experts", "mlp", "embed"),
    "w_gate": ("experts", "embed", "mlp"),
}

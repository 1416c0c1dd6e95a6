"""GPT model family (GPT-2 / GPT-J / Llama-style) in PyTorch — the
counterpart of `ray_tpu/models/gpt.py`: training (`forward` with per-block
remat, `loss_fn`, `make_train_step`) and serving.

Params are a plain dict of tensors in the reference's stacked `[L, ...]`
layout and keys (`models/convert.py` turns a JAX param pytree into one), so
the two packages compare like with like. Each block casts its layer's
weights to `cfg.dtype` before use (a no-op when they are stored in it); the
final norm weight is used as stored. Training keeps f32 master weights and
computes in `cfg.dtype`, as the reference does.

Training: attention runs the flash kernels forward and backward, every
RMSNorm the RMSNorm kernel, through autograd (`ops/attention.py`,
`ops/norms.py`); `cfg.remat` checkpoints each block with
`torch.utils.checkpoint` under the policy `_remat_policy` picks. A MoE
config (`mlp_type="moe"`) replaces each MLP with `ops/moe.py`'s layer and
adds its aux loss to the loss.

Parallelism, in the reference's two modes. `mesh=None`: plain, or inside a
caller's `parallel.shard_fn` (manual SPMD: ring/Ulysses attention talk over
`cfg.sp_axis`, `global_positions` offsets each sequence shard). `mesh`
given (automatic, the reference's pjit mode): params are DTensors placed by
`param_shardings`, and the step is one per-rank program under `shard_fn`
(`_on_mesh`) on each param's local shard:
  * fsdp: a weight's embed dim is gathered where it is used, a layer's
    inside its (checkpointed) block, and the gather's transpose
    reduce-scatters the gradient back onto the fsdp shards (ZeRO-3);
  * tp: heads, the MLP's hidden dim and the vocab stay split (Megatron):
    each rank projects its own heads and hidden units, a psum over tp ends
    the attention output and MLP products, the token embedding looks up
    the rank's vocab rows and psums them, and the LM head and the
    cross-entropy work on the rank's vocab slice;
  * dp × fsdp split the batch; for ring/Ulysses attention sp splits the
    sequence through the whole model;
  * ep: each rank holds its experts, and a MoE layer routes as if
    unsharded (`ops/moe.py`);
  * the loss is the mean over every rank's tokens, and each gradient comes
    back in its param's placement.
DTensor only places the params and carries their shards: its sharding
propagation on the model's ops costs minutes per op on a 3-dim mesh with
the batch split over two of its dims, and refuses the qkv einsum with heads
split over tp (PERF.md).

Two serving paths:
  * dense KV cache: `prefill` + `decode_step`, driven by `make_generate`;
    prefill attention runs the flash kernel (`ops.flash_attention`);
  * paged KV cache for the continuous-batching engine: `prefill_paged`,
    `decode_step_paged`, `verify_step_paged`, attending with plain torch
    (gather + masked softmax), as the reference does with plain jnp.
Every RMSNorm runs the RMSNorm kernel on the card.

Unlike the reference's functional updates, the KV caches are updated IN
PLACE (slice assignment / `index_put_`): the reference donates the cache
buffers to each call, so nothing can observe the old contents either way.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ..device import resolve_device, resolve_dtype
from ..ops import attention_reference, flash_attention, layernorm, rmsnorm, rope_frequencies, rope_rotate
from ..ops.attention import ring_attention, ulysses_attention
from ..parallel.mesh import P, ShardingRules, axes_of, bound_mesh, use_mesh

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_head: int = 64
    d_mlp: int = 3072
    max_seq: int = 1024
    # Architecture knobs.
    norm: str = "layernorm"          # layernorm | rmsnorm
    activation: str = "gelu"         # gelu | swiglu
    pos: str = "learned"             # learned | rotary
    rotary_dim: int = 64
    parallel_block: bool = False     # GPT-J: attn and mlp in parallel
    tie_embeddings: bool = True
    # Mixture-of-Experts (expert parallelism over the ep mesh axis).
    mlp_type: str = "dense"          # dense | moe
    moe_experts: int = 8
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # Execution knobs.
    dtype: Any = torch.bfloat16
    attn_impl: str = "flash"         # flash | ring | ulysses | ref
    remat: bool = True
    # None (save nothing) | "dots" (save matmul outputs) | "attn" (save the
    # flash forward's outputs, so backward never re-runs it).
    remat_policy: Optional[str] = None
    sp_axis: str = "sp"

    def __post_init__(self):
        object.__setattr__(self, "dtype", resolve_dtype(self.dtype))

    @property
    def moe_config(self):
        from ..ops.moe import MoEConfig

        return MoEConfig(
            num_experts=self.moe_experts,
            top_k=self.moe_top_k,
            capacity_factor=self.moe_capacity_factor,
            d_model=self.d_model,
            d_ff=self.d_mlp,
            aux_loss_weight=self.moe_aux_weight,
            activation=self.activation,
            dtype=self.dtype,
        )

    @property
    def n_params(self) -> int:
        E, L, F_, V, Hd = self.d_model, self.n_layers, self.d_mlp, self.vocab_size, self.n_heads * self.d_head
        if self.mlp_type == "moe":
            n_mats = 3 if self.activation == "swiglu" else 2
            mlp_params = self.moe_experts * n_mats * E * F_ + E * self.moe_experts
        else:
            mlp_params = (2 if self.activation == "swiglu" else 1) * E * F_ + F_ * E
        per_layer = E * 3 * Hd + Hd * E + mlp_params
        per_layer += 2 * E  # norms
        total = L * per_layer + V * E + (0 if self.tie_embeddings else E * V)
        if self.pos == "learned":
            total += self.max_seq * E
        return total

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token: 6N + attention term."""
        return 6.0 * self.n_params + 12.0 * self.n_layers * self.d_model * seq_len


# Canonical configs ---------------------------------------------------------
def gpt2_small(**kw):
    return GPTConfig(**{**dict(n_layers=12, d_model=768, n_heads=12, d_mlp=3072), **kw})


def gpt2_medium(**kw):
    return GPTConfig(**{**dict(n_layers=24, d_model=1024, n_heads=16, d_mlp=4096), **kw})


def gpt2_large(**kw):
    return GPTConfig(**{**dict(n_layers=36, d_model=1280, n_heads=20, d_mlp=5120), **kw})


def gpt2_xl(**kw):
    return GPTConfig(**{**dict(n_layers=48, d_model=1600, n_heads=25, d_mlp=6400), **kw})


def gptj_6b(**kw):
    return GPTConfig(**{**dict(
        n_layers=28, d_model=4096, n_heads=16, d_head=256, d_mlp=16384, vocab_size=50432,
        pos="rotary", rotary_dim=64, parallel_block=True, tie_embeddings=False, max_seq=2048,
    ), **kw})


def llama_7b(**kw):
    return GPTConfig(**{**dict(
        n_layers=32, d_model=4096, n_heads=32, d_head=128, d_mlp=11008, vocab_size=32000,
        norm="rmsnorm", activation="swiglu", pos="rotary", rotary_dim=128,
        tie_embeddings=False, max_seq=2048,
    ), **kw})


CONFIGS = {
    "gpt2-small": gpt2_small,
    "gpt2-medium": gpt2_medium,
    "gpt2-large": gpt2_large,
    "gptj-6b": gptj_6b,
    "llama-7b": llama_7b,
}


# ------------------------------------------------------------------- params
def param_logical_dims(cfg: GPTConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical dims per parameter — feed through ShardingRules for shardings."""
    dims = {
        "tok_embed": ("vocab", "embed"),
        "ln_f_w": ("embed_act",),
        "ln_f_b": ("embed_act",),
        "w_qkv": ("layers", "embed", None, "heads", "head_dim"),
        "b_qkv": ("layers", None, "heads", "head_dim"),
        "w_o": ("layers", "heads", "head_dim", "embed"),
        "b_o": ("layers", "embed_act"),
        "ln1_w": ("layers", "embed_act"),
        "ln1_b": ("layers", "embed_act"),
    }
    if cfg.mlp_type == "moe":
        dims["moe_router"] = ("layers", "embed", "experts")
        dims["moe_w_in"] = ("layers", "experts", "embed", "mlp")
        dims["moe_w_out"] = ("layers", "experts", "mlp", "embed")
        if cfg.activation == "swiglu":
            dims["moe_w_gate"] = ("layers", "experts", "embed", "mlp")
    else:
        dims["w_in"] = ("layers", "embed", "mlp")
        dims["b_in"] = ("layers", "mlp_act")
        dims["w_out"] = ("layers", "mlp", "embed")
        dims["b_out"] = ("layers", "embed_act")
        if cfg.activation == "swiglu":
            dims["w_gate"] = ("layers", "embed", "mlp")
    if not cfg.parallel_block:
        dims["ln2_w"] = ("layers", "embed_act")
        dims["ln2_b"] = ("layers", "embed_act")
    if cfg.pos == "learned":
        dims["pos_embed"] = (None, "embed")
    if not cfg.tie_embeddings:
        dims["lm_head"] = ("embed", "vocab")
    return dims


def init_params(cfg: GPTConfig, seed: Union[int, torch.Generator] = 0, device=None,
                dtype: Any = torch.float32) -> Dict[str, torch.Tensor]:
    """Random params with the reference's distributions (normal, std 0.02;
    residual projections std 0.02/sqrt(2L); norms one, biases zero) from a
    seeded `torch.Generator`, made directly on `device` in `dtype` (the
    reference's master params are f32; serving stores cfg.dtype)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(device=dev).manual_seed(seed)
    E, L, F_, V = cfg.d_model, cfg.n_layers, cfg.d_mlp, cfg.vocab_size
    H, Dh = cfg.n_heads, cfg.d_head
    std = 0.02
    resid_std = std / math.sqrt(2 * L)

    def n(shape, s=std):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt).mul_(s)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dt)

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=dt)

    params = {
        "tok_embed": n((V, E)),
        "ln_f_w": ones((E,)),
        "ln_f_b": zeros((E,)),
        "w_qkv": n((L, E, 3, H, Dh)),
        "b_qkv": zeros((L, 3, H, Dh)),
        "w_o": n((L, H, Dh, E), resid_std),
        "b_o": zeros((L, E)),
        "ln1_w": ones((L, E)),
        "ln1_b": zeros((L, E)),
    }
    if cfg.mlp_type == "moe":
        X = cfg.moe_experts
        params["moe_router"] = n((L, E, X))
        params["moe_w_in"] = n((L, X, E, F_))
        params["moe_w_out"] = n((L, X, F_, E), resid_std)
        if cfg.activation == "swiglu":
            params["moe_w_gate"] = n((L, X, E, F_))
    else:
        params["w_in"] = n((L, E, F_))
        params["b_in"] = zeros((L, F_))
        params["w_out"] = n((L, F_, E), resid_std)
        params["b_out"] = zeros((L, E))
        if cfg.activation == "swiglu":
            params["w_gate"] = n((L, E, F_))
    if not cfg.parallel_block:
        params["ln2_w"] = ones((L, E))
        params["ln2_b"] = zeros((L, E))
    if cfg.pos == "learned":
        params["pos_embed"] = n((cfg.max_seq, E))
    if not cfg.tie_embeddings:
        params["lm_head"] = n((E, V))
    return params


def param_shardings(cfg: GPTConfig, mesh, rules: Optional[ShardingRules] = None):
    """name -> DTensor placements (one per mesh dim) of each param; place a
    param with `parallel.place(params[name], mesh, shardings[name])`."""
    rules = rules or ShardingRules.default()
    return {name: rules.placements(mesh, *d) for name, d in param_logical_dims(cfg).items()}


_LAYER_KEYS = (
    "w_qkv", "b_qkv", "w_o", "b_o", "w_in", "b_in", "w_out", "b_out",
    "ln1_w", "ln1_b", "ln2_w", "ln2_b", "w_gate",
    "moe_router", "moe_w_in", "moe_w_out", "moe_w_gate",
)


def _cast_layer(layer, cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """A layer's weights in the compute dtype; the MoE router stays in its
    master dtype (router math is f32)."""
    return {k: (w if k == "moe_router" else w.to(cfg.dtype)) for k, w in layer.items()}


def _layer(params, cfg: GPTConfig, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's weights cast to the compute dtype."""
    return _cast_layer({k: params[k][i] for k in _LAYER_KEYS if k in params}, cfg)


def _refuse_moe(cfg: GPTConfig, what: str) -> None:
    if cfg.mlp_type == "moe":
        raise NotImplementedError(f"{what} does not support MoE yet")


# ------------------------------------------------------------------ forward
def _norm(x, w, b, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, w)
    return layernorm(x, w, b)


def _attention(cfg: GPTConfig, q, k, v):
    """Causal attention on the heads and positions q, k, v hold. Ring and
    Ulysses hold a sequence chunk and talk over `cfg.sp_axis` of the bound
    mesh (a caller's shard_fn, or `_on_mesh`'s, where q, k, v also hold only
    this rank's heads)."""
    if cfg.attn_impl in ("ring", "ulysses"):
        impl = ring_attention if cfg.attn_impl == "ring" else ulysses_attention
        return impl(q, k, v, axis=cfg.sp_axis, causal=True)
    if cfg.attn_impl == "ref":
        return attention_reference(q, k, v, causal=True)
    return flash_attention(q, k, v, causal=True)


def _own_chunk(t, axis: str, dim: int):
    """This rank's chunk of t along dim, split evenly over `axis`."""
    from ..collective.ops import axis_index, axis_size

    n = axis_size(axis)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split over {axis}={n}")
    return t.chunk(n, dim)[axis_index(axis)]


def _table_rows(cfg: GPTConfig, positions):
    """Rows of the position tables (RoPE, learned embeddings) for
    `positions`, clamped to max_seq - 1 as JAX clamps an out-of-range
    gather. A padded prefill chunk or verify slot can sit past max_seq; its
    K/V go to the null block and its output is dropped."""
    return positions.clamp(max=cfg.max_seq - 1)


def _rope_cs(cfg: GPTConfig, rope_tables, positions):
    cos, sin = rope_tables
    rows = _table_rows(cfg, positions)
    return cos[rows], sin[rows]


def _rope_tables(cfg: GPTConfig, device):
    if cfg.pos != "rotary":
        return None
    return rope_frequencies(min(cfg.rotary_dim, cfg.d_head), cfg.max_seq, device=device)


def _rope(cfg: GPTConfig, x, c, s):
    """Rotate the first rotary_dim dims of x by (c, s); partial rotary keeps
    the rest as is."""
    rd = min(cfg.rotary_dim, cfg.d_head)
    if rd < cfg.d_head:
        return torch.cat([rope_rotate(x[..., :rd], c, s), x[..., rd:]], dim=-1)
    return rope_rotate(x, c, s)


def _qkv(cfg: GPTConfig, h, p):
    """h [B, S, E] -> q, k, v [B, H, S, Dh] (qkv weight layout [E, 3, H, Dh];
    H the heads the weight holds)."""
    B, S, E = h.shape
    w = p["w_qkv"]
    qkv = (h @ w.reshape(E, -1)).view(B, S, *w.shape[1:]) + p["b_qkv"]
    return (qkv[:, :, i].transpose(1, 2) for i in range(3))


def _tp_sum(y, auto: bool):
    """A product over this rank's heads or hidden units summed over tp
    (automatic mode; a no-op at tp=1)."""
    if not auto:
        return y
    from ..collective.ops import psum

    return psum(y, "tp")


def _attn_out(cfg: GPTConfig, attn, p, auto: bool = False):
    """attn [B, H, S, Dh] -> [B, S, E]."""
    B, H, S, Dh = attn.shape
    return _tp_sum(attn.transpose(1, 2).reshape(B, S, H * Dh) @ p["w_o"].reshape(H * Dh, -1), auto) + p["b_o"]


def _moe(cfg: GPTConfig, p, x, auto: bool):
    """The MoE layer on x [B, S, E]: (out, aux). Automatic mode routes the
    tokens of every batch rank as one batch, over each sequence whole (the
    reference's token order), on this rank's experts (ep) and hidden units
    (tp)."""
    from ..ops.moe import moe_forward

    moe_params = {"w_router": p["moe_router"], "w_in": p["moe_w_in"], "w_out": p["moe_w_out"]}
    if cfg.activation == "swiglu":
        moe_params["w_gate"] = p["moe_w_gate"]
    if not auto:
        return moe_forward(moe_params, x, cfg.moe_config)
    from ..collective.ops import all_gather

    cp = cfg.attn_impl in ("ring", "ulysses")
    if cp:
        x = all_gather(x, cfg.sp_axis, gather_axis=1)
    y, aux = moe_forward(moe_params, x, cfg.moe_config, token_axis=_rules_spec("batch")[0],
                         expert_axis=_rules_spec("experts")[0])
    y = _tp_sum(y, auto)
    return (_own_chunk(y, cfg.sp_axis, 1) if cp else y), aux


def _mlp_residual(cfg: GPTConfig, x, h, attn_out, p, auto: bool = False):
    """The block's second half: residual add, MLP (or MoE layer), residual
    add. Returns (out, MoE aux loss or None)."""
    if cfg.parallel_block:
        mlp_in = h  # GPT-J: the same normed input feeds attn and mlp
    else:
        x = x + attn_out
        mlp_in = _norm(x, p["ln2_w"], p["ln2_b"], cfg.norm)
    aux = None
    if cfg.mlp_type == "moe":
        mlp_out, aux = _moe(cfg, p, mlp_in, auto)
    else:
        u = mlp_in @ p["w_in"] + p["b_in"]
        if cfg.activation == "swiglu":
            u = F.silu(mlp_in @ p["w_gate"]) * u
        else:
            u = F.gelu(u, approximate="tanh")  # jax.nn.gelu defaults to the tanh form
        mlp_out = _tp_sum(u @ p["w_out"], auto) + p["b_out"]
    return (x + attn_out + mlp_out if cfg.parallel_block else x + mlp_out), aux


def _block(cfg: GPTConfig, rope_tables, x, p, positions, auto: bool = False):
    """One transformer block over a whole sequence; x: [B, S, E] in
    cfg.dtype. Returns (out, MoE aux loss or None, k, v) with the post-RoPE
    K/V [B, H, S, Dh]."""
    h = _norm(x, p["ln1_w"], p["ln1_b"], cfg.norm)
    q, k, v = _qkv(cfg, h, p)
    if cfg.pos == "rotary":
        c, s = _rope_cs(cfg, rope_tables, positions)
        q, k = _rope(cfg, q, c, s), _rope(cfg, k, c, s)
    attn = _attention(cfg, q, k, v)
    out, aux = _mlp_residual(cfg, x, h, _attn_out(cfg, attn, p, auto), p, auto)
    return out, aux, k, v


def _vocab_slice(ids, n_local: int):
    """ids relative to this tp rank's slice of the vocab (automatic mode:
    n_local rows per rank), clamped into it, and whether each id lies in it."""
    from ..collective.ops import axis_index

    local = ids - axis_index("tp") * n_local
    return local.clamp(0, n_local - 1), (local >= 0) & (local < n_local)


def _embed(params, tokens, cfg: GPTConfig, positions, auto: bool = False):
    table = params["tok_embed"]
    if auto:  # this rank's vocab rows, the rest zero, summed over tp
        rows, hit = _vocab_slice(tokens, table.shape[0])
        x = _tp_sum(torch.where(hit[..., None], table[rows], 0), auto).to(cfg.dtype)
    else:
        x = table[tokens].to(cfg.dtype)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][_table_rows(cfg, positions)].to(cfg.dtype)
    return x


def _logits(params, x, cfg: GPTConfig):
    """Final norm (weight as stored) and LM head, in cfg.dtype (automatic
    mode: this rank's slice of the vocab)."""
    x = _norm(x, params["ln_f_w"], params["ln_f_b"], cfg.norm)
    head = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(cfg.dtype)


def _remat_block(cfg: GPTConfig, rope_tables, mesh, auto: bool, layer, x, positions):
    """A block on x with `layer`'s master weights, cast inside (so remat
    recomputes the cast, as the reference's checkpointed block does):
    (out, MoE aux loss or None). Automatic mode gathers the layer's fsdp
    shards here too, so a checkpointed block frees them after its forward
    and gathers them again for its recompute. `mesh` (the bound one, or
    None) is bound again here: a recompute in the backward runs outside the
    caller's shard_fn."""
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        if auto:
            dims = param_logical_dims(cfg)
            layer = {k: _whole(w, dims[k][1:], keep=() if k == "moe_router" else _KEPT_AXES)
                     for k, w in layer.items()}
        return _block(cfg, rope_tables, x, _cast_layer(layer, cfg), positions, auto)[:2]


def global_positions(cfg: GPTConfig, local_seq: int, device=None):
    """Global token positions for this shard (manual-SPMD mode only). Under
    a whole-model shard_fn the function body sees only the LOCAL sequence
    chunk — positions must be offset by this rank's sp-axis index or
    RoPE/learned-pos phases are wrong on every shard but the first."""
    pos = torch.arange(local_seq, device=device)
    if cfg.attn_impl in ("ring", "ulysses"):
        from ..collective.ops import axis_index

        return axis_index(cfg.sp_axis) * local_seq + pos
    return pos


def forward(params, tokens, cfg: GPTConfig, positions=None, mesh=None, return_aux=False):
    """tokens [B, S] (long) -> logits [B, S, V] in cfg.dtype (or (logits,
    MoE aux loss) with return_aux=True). With `cfg.remat` and grad enabled,
    each block is checkpointed under `_remat_policy(cfg)`.

    mesh=None → plain, or a caller-managed shard_fn (manual SPMD).
    mesh given → automatic: params are DTensors on it (`param_shardings`),
    tokens (plain: the global batch, the same on every rank) are split over
    the "batch" axes, and the logits come back as a DTensor split so."""
    if mesh is None:
        return _forward(params, tokens, cfg, positions, return_aux=return_aux)
    tokens_spec = _token_spec(cfg)

    def body(p, t):
        return _forward(p, t, cfg, positions, return_aux=return_aux, auto=True)

    logits_spec = P(*tokens_spec, _rules_spec("vocab")[0])
    out_specs = (logits_spec, P()) if return_aux else logits_spec
    return _on_mesh(mesh, cfg, params, body, (tokens_spec,), out_specs)(params, tokens)


def _rules_spec(*dims):
    return ShardingRules.default().spec(*dims)


# Automatic mode: the axes a weight stays split over where it is used (heads,
# hidden units and vocab over tp, experts over ep); its other axes (fsdp) are
# gathered there.
_KEPT_AXES = ("tp", "ep")


def _token_spec(cfg: GPTConfig):
    """Tokens [B, S] in automatic mode: the batch over the "batch" axes and,
    for ring/Ulysses attention, the sequence over `cfg.sp_axis`."""
    cp = cfg.attn_impl in ("ring", "ulysses")
    return P(_rules_spec("batch")[0], cfg.sp_axis if cp else None)


def _whole(t, dims, keep=()):
    """A local shard `t` of a param laid out by the default rules over the
    logical `dims`, gathered over every mesh axis but `keep`."""
    from ..collective.ops import all_gather

    for i, entry in enumerate(_rules_spec(*dims)):
        for axis in reversed(axes_of(entry)):  # minor axis first
            if axis not in keep:
                t = all_gather(t, axis, gather_axis=i)
    return t


def _on_mesh(mesh, cfg: GPTConfig, params, body, arg_specs, out_specs):
    """`body(params, *args)` as one per-rank program over `mesh` (automatic
    mode), on each param's local shard under the default rules."""
    from ..parallel.spmd import shard_fn

    dims = param_logical_dims(cfg)
    param_specs = {k: _rules_spec(*dims[k]) for k in params}
    return shard_fn(body, mesh, (param_specs, *arg_specs), out_specs)


_OUTER_KEYS = ("tok_embed", "pos_embed", "lm_head", "ln_f_w", "ln_f_b")


def _forward(params, tokens, cfg: GPTConfig, positions=None, return_aux=False, auto=False):
    """The forward on this rank's tokens; auto=True inside `_on_mesh`
    (params are local shards under the default rules)."""
    B, S = tokens.shape
    if positions is None:
        positions = global_positions(cfg, S, tokens.device)
    outer = {k: params[k] for k in _OUTER_KEYS if k in params}
    if auto:
        dims = param_logical_dims(cfg)
        outer = {k: _whole(w, dims[k], keep=_KEPT_AXES) for k, w in outer.items()}
    x = _embed(outer, tokens, cfg, positions, auto)
    rope_tables = _rope_tables(cfg, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    context_fn = _remat_policy(cfg) if remat else None
    # unbind, not params[k][i]: its backward stacks the L layer gradients
    # once, where indexing would add a zero-padded [L, ...] gradient per layer.
    stacks = {k: params[k].unbind(0) for k in _LAYER_KEYS if k in params}
    mesh = bound_mesh()
    auxes = []
    for i in range(cfg.n_layers):
        layer = {k: ws[i] for k, ws in stacks.items()}
        if remat:
            x, aux = checkpoint(_remat_block, cfg, rope_tables, mesh, auto, layer, x, positions,
                                use_reentrant=False, context_fn=context_fn)
        else:
            x, aux = _remat_block(cfg, rope_tables, mesh, auto, layer, x, positions)
        auxes.append(aux)
    logits = _logits(outer, x, cfg)
    if not return_aux:
        return logits
    if cfg.mlp_type != "moe":
        return logits, torch.zeros((), dtype=torch.float32, device=tokens.device)
    return logits, functools.reduce(torch.add, auxes)


# Ops whose outputs a selective-checkpoint policy saves. "dots" follows the
# reference's `dots_with_no_batch_dims_saveable`: matmuls without a batch
# dim (every projection; the model's [B, S, E] @ [E, F] products dispatch
# as `mm`). "attn" saves the flash forward op's (o, lse), as the reference's
# `save_only_these_names("attn_out", "attn_lse")`.
_SAVED_OPS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
    "attn": (torch.ops.ray_tpu_torch.flash_attention.default,),
}


def _remat_policy(cfg: GPTConfig):
    """The `context_fn` of `torch.utils.checkpoint` for cfg.remat_policy:
    None saves nothing (the block is recomputed from its input); "dots" and
    "attn" save their ops' outputs and recompute the rest."""
    if cfg.remat_policy not in (None, "dots", "attn"):
        raise ValueError(f"unknown remat_policy: {cfg.remat_policy!r}")
    if cfg.remat_policy == "attn" and cfg.attn_impl != "flash":
        # Only the flash path runs the saved op; elsewhere the policy would
        # match nothing and silently rematerialize everything.
        raise ValueError(
            "remat_policy='attn' saves flash-attention residuals; it requires "
            f"attn_impl='flash' (got {cfg.attn_impl!r})"
        )
    if cfg.remat_policy is None:
        return noop_context_fn
    saved = _SAVED_OPS[cfg.remat_policy]

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _parse_batch(batch):
    """{"tokens": [B,S+1]} or {"inputs","targets"} -> (inputs, targets, mask)."""
    if "inputs" in batch:
        return batch["inputs"], batch["targets"], batch.get("mask")
    tokens = batch["tokens"]
    mask = batch.get("mask")
    return tokens[:, :-1], tokens[:, 1:], (mask[:, 1:] if mask is not None else None)


def _vocab_log_likelihood(logits, targets):
    """log p(target) in f32 from logits whose vocab is split over tp (the
    automatic mode's LM head): this rank's slice of the softmax sums, its
    target logits, each summed over tp. At tp=1, `log_softmax` itself."""
    from ..collective.ops import axis_size, pmax, psum

    z = logits.float()
    if axis_size("tp") == 1:
        return torch.log_softmax(z, dim=-1).gather(-1, targets.long()[..., None])[..., 0]
    top = pmax(z.detach().amax(dim=-1), "tp")
    lse = torch.log(psum(torch.exp(z - top[..., None]).sum(dim=-1), "tp")) + top
    rows, hit = _vocab_slice(targets.long(), z.shape[-1])
    picked = torch.where(hit, z.gather(-1, rows[..., None])[..., 0], 0)
    return psum(picked, "tp") - lse


def _ce_loss(logits, targets, mask):
    """Mean next-token cross-entropy (f32), optionally padding-masked."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is not None:
        m = mask.float()
        return -(ll * m).sum() / m.sum().clamp_min(1.0)
    return -ll.mean()


def loss_fn(params, batch, cfg: GPTConfig, mesh=None):
    """batch: {"tokens": [B, S+1]} or {"inputs", "targets"[, "mask"]} ->
    mean next-token cross-entropy (f32) + MoE aux (a MoE config only: the
    reference adds 0 for a dense one). With `mesh` the batch (plain: the
    global batch, the same on every rank) is split as `forward` splits it,
    the mean is taken over every rank's tokens, and the loss is a
    replicated DTensor."""
    inputs, targets, mask = _parse_batch(batch)
    if mesh is None:
        logits, aux = forward(params, inputs, cfg, return_aux=True)
        loss = _ce_loss(logits, targets, mask)
        return loss + aux if cfg.mlp_type == "moe" else loss
    spec = _token_spec(cfg)
    token_axes = tuple(a for entry in spec for a in axes_of(entry))

    def body(p, inputs, targets, mask):
        logits, aux = _forward(p, inputs, cfg, return_aux=True, auto=True)
        loss = _mean_nll(_vocab_log_likelihood(logits, targets), mask, token_axes)
        return loss + aux if cfg.mlp_type == "moe" else loss

    return _on_mesh(mesh, cfg, params, body, (spec, spec, spec), P())(params, inputs, targets, mask)


def _mean_nll(ll, mask, token_axes):
    """The mean negative log-likelihood over every rank's tokens (automatic
    mode): each rank's mean averaged over the token axes (each rank holds as
    many tokens), or the masked sum over the masked count. At one rank it
    is `_ce_loss`'s arithmetic op for op, so the one-rank mesh step is the
    plain step bit for bit."""
    from ..collective.ops import pmean, psum

    if mask is None:
        return -pmean(ll.mean(), token_axes)
    m = mask.float()
    return -psum((ll * m).sum(), token_axes) / psum(m.sum(), token_axes).clamp_min(1.0)


def optax_global_norm(tensors):
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def make_train_step(cfg: GPTConfig, optimizer, mesh=None, loss=None) -> Callable:
    """Returns `step(params, batch) -> (params, metrics)` with metrics
    {"loss", "grad_norm"} (0-dim f32 tensors; reading them synchronizes).
    `optimizer` is a torch optimizer over `params.values()` (the port's
    `optim.AdamW` for the reference's optax.adamw). The params are updated
    IN PLACE: the reference donates its state to the step. With `mesh` the
    params are DTensors placed by `param_shardings` (each gradient comes
    back in its param's placement, and AdamW updates each rank's shard).
    `loss` overrides the loss callable (params, batch) -> scalar: the
    pipeline train step rides this hook."""
    if loss is None:
        def loss(params, batch):
            return loss_fn(params, batch, cfg, mesh)

    def step(params, batch):
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        value = loss(params, batch)
        value.backward()
        gnorm = optax_global_norm(p.grad for p in params.values() if p.grad is not None)
        optimizer.step()
        if mesh is not None:
            value, gnorm = value.full_tensor(), gnorm.full_tensor()
        return params, {"loss": value.detach(), "grad_norm": gnorm.detach()}

    return step


# ------------------------------------------------------- pipeline parallelism
def split_stage_params(params, cfg: GPTConfig, num_stages: int):
    """Reshape the [L, ...] layer stack to [S, L/S, ...] (the `stage` logical
    dim: shard it over pp so each pp rank holds exactly its stage's layers).
    Non-layer params (embeddings, final norm, head) stay as they are; they
    live outside the pipelined region. Every returned tensor is a leaf (a
    detached view of the given one), so an optimizer can be built over
    them."""
    if cfg.n_layers % num_stages != 0:
        raise ValueError(f"{cfg.n_layers} layers not divisible by {num_stages} stages")
    per = cfg.n_layers // num_stages
    out = {}
    for k, v in params.items():
        if k in _LAYER_KEYS:
            out[k] = v.detach().reshape(num_stages, per, *v.shape[1:])
        else:
            out[k] = v.detach()
    return out


def merge_stage_params(params, cfg: GPTConfig):
    """Inverse of split_stage_params ([S, L/S, ...] -> [L, ...])."""
    out = {}
    for k, v in params.items():
        if k in _LAYER_KEYS:
            out[k] = v.detach().reshape(v.shape[0] * v.shape[1], *v.shape[2:])
        else:
            out[k] = v.detach()
    return out


def _stage_dims(cfg: GPTConfig):
    """Logical dims of the stage-split layout: layer arrays gain a leading
    `stage` dim (-> pp); the rest as `param_logical_dims`."""
    dims = param_logical_dims(cfg)
    for name, d in dims.items():
        if name in _LAYER_KEYS:
            assert d[0] == "layers"
            dims[name] = ("stage", *d)
    return dims


def pipeline_stage_shardings(cfg: GPTConfig, mesh, rules: Optional[ShardingRules] = None):
    """name -> DTensor placements of each param in the stage-split layout:
    layer arrays gain a leading `stage` dim (-> pp); the rest match
    param_shardings."""
    rules = rules or ShardingRules.default()
    return {name: rules.placements(mesh, *d) for name, d in _stage_dims(cfg).items()}


def pipeline_loss_fn(params, batch, cfg: GPTConfig, mesh, num_microbatches: int):
    """GPipe loss: the transformer stack runs as a pipeline over `pp`,
    microbatches flowing stage to stage by ppermute (`parallel/pipeline.py`),
    while each stage's blocks are partitioned over dp/fsdp/tp as the
    automatic mode partitions them (fsdp gathered per layer, tp split
    Megatron-style). Embeddings, the final norm, the head and the loss stay
    outside the pipelined region. `params` is the stage-split layout of
    split_stage_params (plain, or DTensors placed by
    pipeline_stage_shardings); the loss comes back as a replicated DTensor.

    The reference makes only `pp` manual and lets XLA partition each stage
    over the other axes; the port's automatic mode is one per-rank program
    on every axis (DTensor propagation cannot carry the model's ops, see
    `_on_mesh`), so the pipeline is that program with the tick loop inside.
    Each microbatch is split over the batch axes, so the tokens of
    microbatch m are the reference's microbatch m (a MoE layer routes them
    as one batch).

    Limitations (the reference's): manual sp attention (ring/Ulysses)
    cannot nest inside the pp-manual region, so those impls are rejected.
    The MoE aux loss is averaged per microbatch (about the full-batch
    value), bubble ticks masked out."""
    from ..collective.ops import axis_index, psum
    from ..parallel.mesh import axis_size
    from ..parallel.pipeline import gpipe_ticks
    from ..parallel.spmd import shard_fn

    if cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} needs its own manual sp axis and "
            "cannot nest inside the pp-manual pipeline region; use 'flash' "
            "or 'ref'."
        )
    S_pp = axis_size(mesh, "pp")
    M = num_microbatches
    inputs, targets, mask = _parse_batch(batch)
    B, S_len = inputs.shape
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by num_microbatches {M}")
    per = cfg.n_layers // S_pp
    dims = _stage_dims(cfg)
    param_specs = {k: _rules_spec(*dims[k]) for k in params}
    batch_axes = _rules_spec("batch")[0]
    token_axes = axes_of(batch_axes)
    spec = P(None, batch_axes, None)  # [M, B/M, S]: each microbatch split over the batch axes

    def micro(t):
        return None if t is None else t.reshape(M, B // M, *t.shape[1:])

    def body(p, inputs, targets, mask):
        _, b, S = inputs.shape
        positions = global_positions(cfg, S, inputs.device)
        outer = {k: _whole(p[k], dims[k], keep=_KEPT_AXES) for k in _OUTER_KEYS if k in p}
        x = _embed(outer, inputs.reshape(M * b, S), cfg, positions, auto=True).reshape(M, b, S, -1)
        rope_tables = _rope_tables(cfg, inputs.device)
        remat = cfg.remat and torch.is_grad_enabled()
        context_fn = _remat_policy(cfg) if remat else None
        stacks = {k: p[k][0].unbind(0) for k in _LAYER_KEYS if k in p}  # this stage's L/S layers
        bound = bound_mesh()

        def stage_fn(act):
            aux_sum = None
            for i in range(per):
                layer = {k: ws[i] for k, ws in stacks.items()}
                if remat:
                    act, aux = checkpoint(_remat_block, cfg, rope_tables, bound, True, layer, act, positions,
                                          use_reentrant=False, context_fn=context_fn)
                else:
                    act, aux = _remat_block(cfg, rope_tables, bound, True, layer, act, positions)
                if aux is not None:
                    aux_sum = aux if aux_sum is None else aux_sum + aux
            return act, aux_sum

        outs, auxes = gpipe_ticks(stage_fn, x, S_pp, "pp")
        y = psum(outs, "pp").reshape(M * b, S, -1)
        # The reference casts the final norm's weights to cfg.dtype here
        # (`ray_tpu/models/gpt.py:841`), where its serial forward uses them
        # as stored. Its f32 casts at the shard_map boundary (`:775-778`,
        # `:826-828`) are XLA workarounds and exact round trips: dropped.
        head = dict(outer, ln_f_w=outer["ln_f_w"].to(cfg.dtype), ln_f_b=outer["ln_f_b"].to(cfg.dtype))
        loss = _mean_nll(_vocab_log_likelihood(_logits(head, y, cfg), targets.reshape(M * b, S)),
                         None if mask is None else mask.reshape(M * b, S), token_axes)
        if cfg.mlp_type != "moe":
            return loss
        # Stage s holds real data only for ticks s <= t < s + M; bubble
        # ticks chew zeros and must not pollute the MoE aux loss.
        s = axis_index("pp")
        aux = functools.reduce(torch.add, [a * float(s <= t < s + M) for t, a in auxes])
        return loss + psum(aux, "pp") / M

    return shard_fn(body, mesh, (param_specs, spec, spec, spec), P())(
        params, micro(inputs), micro(targets), micro(mask))


def make_pipeline_train_step(cfg: GPTConfig, optimizer, mesh, num_microbatches: int) -> Callable:
    """`step(params, batch) -> (params, metrics)` with the GPipe pipeline
    inside (pp x dp/fsdp/tp composition); params in the stage-split layout,
    placed by pipeline_stage_shardings."""
    return make_train_step(
        cfg,
        optimizer,
        mesh,
        loss=lambda params, batch: pipeline_loss_fn(params, batch, cfg, mesh, num_microbatches),
    )


# ---------------------------------------------------------------- generation
def init_cache(cfg: GPTConfig, batch: int, max_seq: Optional[int] = None, device=None):
    """Dense decode cache: stacked per-layer post-RoPE K/V
    [L, B, H, M, Dh] in cfg.dtype + the current length (a Python int)."""
    dev = resolve_device(device)
    M = max_seq or cfg.max_seq
    shape = (cfg.n_layers, batch, cfg.n_heads, M, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "len": 0,
    }


@torch.inference_mode()
def prefill(params, tokens, cfg: GPTConfig, cache):
    """Run the prompt [B, S0] through the model, filling cache[:, :, :, :S0]
    in place. Returns (last-position logits [B, V] f32, cache)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    x = _embed(params, tokens, cfg, positions)
    rope_tables = _rope_tables(cfg, tokens.device)
    for i in range(cfg.n_layers):
        x, _, k, v = _block(cfg, rope_tables, x, _layer(params, cfg, i), positions)
        cache["k"][i, :, :, :S] = k
        cache["v"][i, :, :, :S] = v
    cache["len"] = S
    return _logits(params, x[:, -1], cfg).float(), cache


def _masked_softmax_attention(q, k, v, visible, scale: float):
    """Plain attention of q [..., S, Dh] over k/v [..., T, Dh]: f32 logits,
    `visible` (broadcast to [..., S, T]) masks, probs cast to v's dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = scores.masked_fill(~visible, _NEG_INF)
    return torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)


@torch.inference_mode()
def decode_step(params, token, cache, cfg: GPTConfig):
    """One step: token [B] -> (logits [B, V] f32, cache). Attention is a
    plain masked dot against the cache (one query: flash brings nothing)."""
    _refuse_moe(cfg, "decode_step")
    pos = cache["len"]
    M = cache["k"].shape[3]
    if pos >= M:
        raise ValueError(f"decode cache full ({M} positions)")
    pos_t = torch.tensor([pos], device=token.device)
    x = _embed(params, token[:, None], cfg, pos_t)
    if cfg.pos == "rotary":
        c, s = _rope_cs(cfg, _rope_tables(cfg, token.device), pos_t)
    scale = 1.0 / math.sqrt(cfg.d_head)
    visible = torch.arange(M, device=token.device) <= pos
    for i in range(cfg.n_layers):
        p = _layer(params, cfg, i)
        h = _norm(x, p["ln1_w"], p["ln1_b"], cfg.norm)
        q, k, v = _qkv(cfg, h, p)
        if cfg.pos == "rotary":
            q, k = _rope(cfg, q, c, s), _rope(cfg, k, c, s)
        ck, cv = cache["k"][i], cache["v"][i]
        ck[:, :, pos:pos + 1] = k
        cv[:, :, pos:pos + 1] = v
        attn = _masked_softmax_attention(q, ck, cv, visible, scale)
        x = _mlp_residual(cfg, x, h, _attn_out(cfg, attn, p), p)[0]
    cache["len"] = pos + 1
    return _logits(params, x[:, -1], cfg).float(), cache


def make_generate(cfg: GPTConfig, max_new_tokens: int, temperature: float = 0.0) -> Callable:
    """Returns `gen(params, prompt [B, S0], generator=None) -> tokens
    [B, max_new_tokens]` (long, on the prompt's device): prefill, then one
    decode step per further token. Greedy at temperature 0; otherwise
    categorical sampling from `generator`."""

    def sample(logits, generator):
        if temperature <= 0.0:
            return logits.argmax(-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def gen(params, prompt, generator: Optional[torch.Generator] = None):
        prompt = prompt.long()
        B, S0 = prompt.shape
        cache = init_cache(cfg, B, S0 + max_new_tokens, device=prompt.device)
        logits, cache = prefill(params, prompt, cfg, cache)
        tok = sample(logits, generator)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = decode_step(params, tok, cache, cfg)
            tok = sample(logits, generator)
            out.append(tok)
        return torch.stack(out, dim=1)

    return gen


# --------------------------------------------------- paged KV-cache decode
# Block-table cache layout for the continuous-batching engine: the KV cache
# is a pool of fixed-size token blocks [L, NB, H, BS, Dh]; token position p
# of a sequence lives at (table[p // BS], p % BS). Block 0 is the engine's
# null block: padding lanes point their tables at it so their writes land
# somewhere harmless.


def init_paged_cache(cfg: GPTConfig, num_blocks: int, block_size: int, device=None):
    """Physical paged KV pool: {"k", "v"} of [L, NB, H, BS, Dh] in cfg.dtype."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, cfg.n_heads, block_size, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _rope_qk(cfg: GPTConfig, q, k, rope_tables, positions):
    """RoPE for [B, H, 1, Dh] q/k at per-lane positions [B]."""
    c, s = _rope_cs(cfg, rope_tables, positions)
    c, s = c[:, None, None, :], s[:, None, None, :]  # [B, 1, 1, rd/2]
    return _rope(cfg, q, c, s), _rope(cfg, k, c, s)


def _gather(pool, tables):
    """pool [NB, H, BS, Dh], tables [..., W] -> [..., H, W*BS, Dh]."""
    g = pool[tables]                         # [..., W, H, BS, Dh]
    *lead, W, H, BS, Dh = g.shape
    return g.transpose(-4, -3).reshape(*lead, H, W * BS, Dh)


@torch.inference_mode()
def prefill_paged(params, tokens, real_len: int, pos_offset: int, block_table, kv, cfg: GPTConfig):
    """One prefill CHUNK of one sequence into the paged cache.

    tokens [1, Sp] right-padded to the shape bucket holds
    prompt[pos_offset : pos_offset + real_len]; block_table [W] maps the
    sequence's blocks. Each layer scatters the chunk's K/V to its (block,
    offset) slots first, then attends over the gathered table history, so
    prefix-cache hits and earlier chunks are read from the cache. K/V of
    padded positions go to the null block. Returns (next-token logits [V]
    f32 at position pos_offset + real_len - 1, kv); only meaningful on the
    final chunk of a prompt."""
    _refuse_moe(cfg, "paged decode")
    dev = tokens.device
    _, Sp = tokens.shape
    BS = kv["k"].shape[3]
    W = block_table.shape[0]
    M = W * BS
    scale = 1.0 / math.sqrt(cfg.d_head)
    rel = torch.arange(Sp, device=dev)
    positions = pos_offset + rel
    x = _embed(params, tokens, cfg, positions)
    if cfg.pos == "rotary":
        c, s = _rope_cs(cfg, _rope_tables(cfg, dev), positions)
    valid = rel < real_len
    phys = torch.where(valid, block_table[torch.clamp(positions // BS, max=W - 1)], 0)
    off = positions % BS
    visible = torch.arange(M, device=dev)[None, :] <= positions[:, None]    # [Sp, M]
    for i in range(cfg.n_layers):
        p = _layer(params, cfg, i)
        h = _norm(x, p["ln1_w"], p["ln1_b"], cfg.norm)
        q, k, v = _qkv(cfg, h, p)
        if cfg.pos == "rotary":
            q, k = _rope(cfg, q, c, s), _rope(cfg, k, c, s)
        kk, vv = kv["k"][i], kv["v"][i]  # views: [NB, H, BS, Dh]
        # The two index tensors are split by a slice, so the indexed dims
        # come first: kk[phys, :, off] is [Sp, H, Dh].
        kk[phys, :, off] = k[0].transpose(0, 1)
        vv[phys, :, off] = v[0].transpose(0, 1)
        attn = _masked_softmax_attention(q[0], _gather(kk, block_table), _gather(vv, block_table),
                                         visible, scale)
        x = _mlp_residual(cfg, x, h, _attn_out(cfg, attn[None], p), p)[0]
    h = x[:, max(real_len - 1, 0)]  # [1, E]: last real chunk position
    return _logits(params, h, cfg)[0].float(), kv


@torch.inference_mode()
def decode_step_paged(params, token, positions, block_tables, kv, cfg: GPTConfig):
    """One iteration-level decode step over the paged cache: token [B] (each
    lane's current token, written at positions[b]), positions [B],
    block_tables [B, W]. Returns (logits [B, V] f32, kv). Padding lanes
    (null-block tables, position 0) give garbage logits the engine drops."""
    _refuse_moe(cfg, "paged decode")
    dev = token.device
    BS = kv["k"].shape[3]
    M = block_tables.shape[1] * BS
    scale = 1.0 / math.sqrt(cfg.d_head)
    x = _embed(params, token[:, None], cfg, positions[:, None])
    rope_tables = _rope_tables(cfg, dev)
    phys = block_tables.gather(1, (positions // BS)[:, None])[:, 0]
    off = positions % BS
    visible = (torch.arange(M, device=dev)[None, :] <= positions[:, None])[:, None, None, :]
    for i in range(cfg.n_layers):
        p = _layer(params, cfg, i)
        h = _norm(x, p["ln1_w"], p["ln1_b"], cfg.norm)
        q, k, v = _qkv(cfg, h, p)
        if cfg.pos == "rotary":
            q, k = _rope_qk(cfg, q, k, rope_tables, positions)
        kk, vv = kv["k"][i], kv["v"][i]
        kk[phys, :, off] = k[:, :, 0]
        vv[phys, :, off] = v[:, :, 0]
        attn = _masked_softmax_attention(q, _gather(kk, block_tables), _gather(vv, block_tables),
                                         visible, scale)
        x = _mlp_residual(cfg, x, h, _attn_out(cfg, attn, p), p)[0]
    return _logits(params, x[:, -1], cfg).float(), kv


@torch.inference_mode()
def verify_step_paged(params, tokens, positions, valid_len, block_tables, kv, cfg: GPTConfig):
    """Speculative-decode verify: score each lane's current token plus its
    draft in ONE forward. tokens [B, K1]: lane b's token j sits at position
    positions[b] + j; valid_len [B] counts real tokens (0 for padding
    lanes; K/V of slots at or past it go to the null block). Query j
    attends to history 0..positions[b]+j, so logits[b, j] equal what
    sequential decode would give after accepting drafts 0..j-1. Returns
    (logits [B, K1, V] f32, kv)."""
    _refuse_moe(cfg, "paged decode")
    dev = tokens.device
    B, K1 = tokens.shape
    W = block_tables.shape[1]
    BS = kv["k"].shape[3]
    M = W * BS
    scale = 1.0 / math.sqrt(cfg.d_head)
    pos = positions[:, None] + torch.arange(K1, device=dev)[None, :]        # [B, K1]
    x = _embed(params, tokens, cfg, pos)
    if cfg.pos == "rotary":
        c, s = _rope_cs(cfg, _rope_tables(cfg, dev), pos)
        c, s = c[:, None], s[:, None]                                       # [B, 1, K1, rd/2]
    valid = torch.arange(K1, device=dev)[None, :] < valid_len[:, None]
    phys = torch.where(valid, block_tables.gather(1, torch.clamp(pos // BS, max=W - 1)), 0)
    off = pos % BS
    visible = (torch.arange(M, device=dev)[None, None, :] <= pos[:, :, None])[:, None]  # [B,1,K1,M]
    for i in range(cfg.n_layers):
        p = _layer(params, cfg, i)
        h = _norm(x, p["ln1_w"], p["ln1_b"], cfg.norm)
        q, k, v = _qkv(cfg, h, p)
        if cfg.pos == "rotary":
            q, k = _rope(cfg, q, c, s), _rope(cfg, k, c, s)
        kk, vv = kv["k"][i], kv["v"][i]
        kk[phys, :, off] = k.transpose(1, 2)                                # [B, K1, H, Dh]
        vv[phys, :, off] = v.transpose(1, 2)
        attn = _masked_softmax_attention(q, _gather(kk, block_tables), _gather(vv, block_tables),
                                         visible, scale)
        x = _mlp_residual(cfg, x, h, _attn_out(cfg, attn, p), p)[0]
    return _logits(params, x, cfg).float(), kv

"""HuggingFace Transformers interop: GPT-2-family checkpoints ↔ the port's GPT.

The port of `ray_tpu/train/huggingface.py`. Reference analog:
`python/ray/train/huggingface/` (TransformersTrainer et al.), which wraps
HF's torch Trainer inside a DDP gang. Here the HF checkpoint is converted
ONCE into the framework's param layout (`params_from_hf`, numpy in the
reference's layout), trained with the port's GPT train step on the card
(`models.gpt.make_train_step` with `optim.AdamW`), and exported back to an
HF state dict (`params_to_hf_state_dict`). The conversions need no
`transformers`: a state dict of torch tensors and a config object with
GPT-2's fields are enough.

Layout notes (HF GPT-2 `Conv1D` stores [in, out], which matches the
einsum-ready layouts directly):
    c_attn.weight [E, 3E]  -> w_qkv [E, 3, H, Dh]   (qkv blocks, head-major)
    c_proj.weight [E, E]   -> w_o   [H, Dh, E]
    mlp.c_fc / c_proj      -> w_in [E, F] / w_out [F, E]
HF's vocab (50257) is zero-padded up to a multiple of 128 (50304); padded
rows never receive gradient signal from real tokens and are sliced off
again on export.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..device import resolve_device
from ..models.gpt import GPTConfig
from .checkpoint import Checkpoint
from .config import RunConfig, ScalingConfig
from .torch_trainer import TorchTrainer


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _np(t, dtype):
    return np.asarray(t.detach().cpu().numpy(), dtype)


def config_from_hf(hf_config, **overrides) -> GPTConfig:
    """GPT2Config (or any object with its fields) -> GPTConfig (vocab padded
    to a multiple of 128)."""
    E, H = hf_config.n_embd, hf_config.n_head
    kw: Dict[str, Any] = dict(
        vocab_size=_round_up(hf_config.vocab_size, 128),
        n_layers=hf_config.n_layer,
        d_model=E,
        n_heads=H,
        d_head=E // H,
        d_mlp=(getattr(hf_config, "n_inner", None) or 4 * E),
        max_seq=hf_config.n_positions,
        norm="layernorm",
        activation="gelu",
        pos="learned",
        tie_embeddings=True,
    )
    kw.update(overrides)
    return GPTConfig(**kw)


def _strip_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {
        (k[len("transformer."):] if k.startswith("transformer.") else k): v
        for k, v in sd.items()
    }


def params_from_hf(
    model, cfg: Optional[GPTConfig] = None, dtype=np.float32
) -> Tuple[Dict[str, np.ndarray], GPTConfig]:
    """GPT2LMHeadModel / GPT2Model / state_dict -> (params, cfg).

    Params come back as numpy (master-precision f32 by default): move them
    to the card with `torch.tensor(v, device=...)`; `models.gpt.forward`
    casts to cfg.dtype layer by layer.
    """
    if hasattr(model, "state_dict"):
        sd = model.state_dict()
        if cfg is None:
            cfg = config_from_hf(model.config)
    else:
        sd = model
        if cfg is None:
            raise ValueError("pass cfg= when converting a raw state_dict")
    sd = _strip_prefix(sd)
    L, E, H, Dh = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head

    def one(key):
        return _np(sd[key], dtype)

    def stack(key):
        return np.stack([_np(sd[f"h.{i}.{key}"], dtype) for i in range(L)])

    wte = one("wte.weight")
    tok = np.zeros((cfg.vocab_size, E), dtype)
    tok[: wte.shape[0]] = wte
    params: Dict[str, np.ndarray] = {
        "tok_embed": tok,
        "pos_embed": one("wpe.weight"),
        "ln_f_w": one("ln_f.weight"),
        "ln_f_b": one("ln_f.bias"),
        "w_qkv": stack("attn.c_attn.weight").reshape(L, E, 3, H, Dh),
        "b_qkv": stack("attn.c_attn.bias").reshape(L, 3, H, Dh),
        "w_o": stack("attn.c_proj.weight").reshape(L, H, Dh, E),
        "b_o": stack("attn.c_proj.bias"),
        "ln1_w": stack("ln_1.weight"),
        "ln1_b": stack("ln_1.bias"),
        "ln2_w": stack("ln_2.weight"),
        "ln2_b": stack("ln_2.bias"),
        "w_in": stack("mlp.c_fc.weight"),
        "b_in": stack("mlp.c_fc.bias"),
        "w_out": stack("mlp.c_proj.weight"),
        "b_out": stack("mlp.c_proj.bias"),
    }
    if not cfg.tie_embeddings:
        lm = one("lm_head.weight")  # [V, E]
        head = np.zeros((E, cfg.vocab_size), dtype)
        head[:, : lm.shape[0]] = lm.T
        params["lm_head"] = head
    return params, cfg


def params_to_hf_state_dict(
    params: Dict[str, Any], cfg: GPTConfig, hf_vocab_size: Optional[int] = None
) -> Dict[str, Any]:
    """Inverse of `params_from_hf` (torch tensors, vocab padding sliced
    off) — load into a GPT2LMHeadModel with `load_state_dict(strict=False)`
    (HF keeps non-parameter `attn.bias` mask buffers we don't carry)."""
    import torch

    L, E, H, Dh = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head
    V = hf_vocab_size or cfg.vocab_size

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))

    p = {k: np.asarray(v) for k, v in params.items()}
    sd = {
        "transformer.wte.weight": t(p["tok_embed"][:V]),
        "transformer.wpe.weight": t(p["pos_embed"]),
        "transformer.ln_f.weight": t(p["ln_f_w"]),
        "transformer.ln_f.bias": t(p["ln_f_b"]),
        "lm_head.weight": t(
            p["tok_embed"][:V]
            if cfg.tie_embeddings
            else p["lm_head"].T[:V]
        ),
    }
    for i in range(L):
        h = f"transformer.h.{i}"
        sd[f"{h}.attn.c_attn.weight"] = t(p["w_qkv"][i].reshape(E, 3 * H * Dh))
        sd[f"{h}.attn.c_attn.bias"] = t(p["b_qkv"][i].reshape(3 * H * Dh))
        sd[f"{h}.attn.c_proj.weight"] = t(p["w_o"][i].reshape(H * Dh, E))
        sd[f"{h}.attn.c_proj.bias"] = t(p["b_o"][i])
        sd[f"{h}.ln_1.weight"] = t(p["ln1_w"][i])
        sd[f"{h}.ln_1.bias"] = t(p["ln1_b"][i])
        sd[f"{h}.ln_2.weight"] = t(p["ln2_w"][i])
        sd[f"{h}.ln_2.bias"] = t(p["ln2_b"][i])
        sd[f"{h}.mlp.c_fc.weight"] = t(p["w_in"][i])
        sd[f"{h}.mlp.c_fc.bias"] = t(p["b_in"][i])
        sd[f"{h}.mlp.c_proj.weight"] = t(p["w_out"][i])
        sd[f"{h}.mlp.c_proj.bias"] = t(p["b_out"][i])
    return sd


# ----------------------------------------------------------------- trainer
def _default_train_loop(config: Dict[str, Any]):
    """Per-worker finetune loop: converted HF params + the port's GPT train
    step on this worker's card, batches from the Ray Data shard. (The
    reference's jax.device_put, optax.adamw and jax.jit of the step,
    `ray_tpu/train/huggingface.py:171-179`, are the port's tensors on the
    device, `optim.AdamW` and the eager step.)"""
    import torch

    from .. import train
    from ..core import api
    from ..models import gpt
    from ..optim import AdamW

    cfg: GPTConfig = config["gpt_config"]
    # This worker's card unless the config asks for another device; a worker
    # without a card raises unless asked for the CPU.
    dev = resolve_device(config.get("device"))
    if config.get("device") is None:
        dev = train.torch.get_device()
    # The params come from the object store (`TransformersTrainer.fit`); the
    # reference ships them inside the config (`:174`).
    params = {k: torch.tensor(v, device=dev) for k, v in api.get(config["init_params"]).items()}
    opt = AdamW(
        params.values(), lr=config.get("lr", 5e-5), weight_decay=config.get("weight_decay", 0.01)
    )
    step = gpt.make_train_step(cfg, opt)

    shard = train.get_dataset_shard("train")
    steps = int(config.get("steps", 100))
    bsz = int(config.get("batch_size", 8))
    done = 0
    last = float("nan")
    while done < steps:
        got_any = False
        for batch in shard.iter_torch_batches(batch_size=bsz, drop_last=True, device=dev):
            got_any = True
            if done >= steps:
                break
            params, metrics = step(params, {"tokens": batch["tokens"]})
            last = float(metrics["loss"])
            done += 1
            if done % max(1, steps // 5) == 0:
                train.report({"loss": last, "step": done})
        if not got_any:
            raise ValueError(
                f"train dataset shard yields no batches at batch_size={bsz} "
                "with drop_last=True — fewer rows than one batch?"
            )
    final = {k: v.detach().cpu().numpy() for k, v in params.items()}
    train.report(
        {"loss": last, "step": done, "done": True},
        checkpoint=Checkpoint.from_dict(
            {"params": final, "hf_state_dict_ready": True}
        ),
    )


class TransformersTrainer(TorchTrainer):
    """Finetune an HF GPT-2-family model with the port's train step.

    Reference analog: `python/ray/train/huggingface/transformers/` — same
    job (HF checkpoint in, finetuned checkpoint out, Ray Data in the
    middle), different engine (the port's GPT step instead of a wrapped
    torch Trainer). The checkpoint's `params` convert back to an HF state
    dict via `params_to_hf_state_dict`. The loop runs on the card; without
    one the trainer raises unless `train_loop_config["device"]` asks for
    the CPU. `fit()` puts the params in the object store, so a loop given as
    `train_loop_per_worker` finds an ObjectRef in `config["init_params"]`
    and must `get` it (the reference hands it the params dict).

        trainer = TransformersTrainer(
            model=GPT2LMHeadModel(cfg),        # or (params, gpt_config)
            datasets={"train": ds},            # {"tokens": [S+1] int32} rows
            train_loop_config={"steps": 50, "batch_size": 8, "lr": 5e-5},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        )
        result = trainer.fit()
    """

    def __init__(
        self,
        *,
        model,
        datasets,
        train_loop_config: Optional[dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        gpt_config: Optional[GPTConfig] = None,
        train_loop_per_worker=None,
    ):
        # The port's entry points raise without a card unless asked for the
        # CPU (the reference's runs wherever JAX runs).
        resolve_device((train_loop_config or {}).get("device"))
        if isinstance(model, tuple):
            init_params, cfg = model
            if gpt_config is not None:
                cfg = gpt_config
        else:
            init_params, cfg = params_from_hf(model, gpt_config)
        loop_cfg = dict(train_loop_config or {})
        loop_cfg["gpt_config"] = cfg
        loop_cfg["init_params"] = init_params
        super().__init__(
            train_loop_per_worker or _default_train_loop,
            train_loop_config=loop_cfg,
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
        )

    def fit(self):
        """Puts the params in the object store once and runs the gang, whose
        loop takes them from there: at gpt2-large widths they are 3.1 GB,
        past the 2 GB a task message can carry (the reference ships them
        inside `train_loop_config`, `ray_tpu/train/huggingface.py:250-253`)."""
        from ..core import api

        params = self.train_loop_config["init_params"]
        self.train_loop_config["init_params"] = api.put({k: np.asarray(v) for k, v in params.items()})
        try:
            return super().fit()
        finally:
            self.train_loop_config["init_params"] = params

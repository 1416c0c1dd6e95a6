from .attention import (
    attention_reference,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_attention_with_stats,
    ring_attention,
    ulysses_attention,
)
from .moe import MoEConfig, moe_forward, moe_init, moe_router
from .norms import layernorm, rmsnorm, rmsnorm_plain
from .rope import rope_frequencies, rope_rotate

__all__ = [
    "attention_reference",
    "flash_attention",
    "flash_attention_bwd_plain",
    "flash_attention_plain",
    "flash_attention_with_stats",
    "ring_attention",
    "ulysses_attention",
    "MoEConfig",
    "moe_init",
    "moe_forward",
    "moe_router",
    "layernorm",
    "rmsnorm",
    "rmsnorm_plain",
    "rope_frequencies",
    "rope_rotate",
]

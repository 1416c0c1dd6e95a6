from .attention import (
    attention_reference,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_attention_with_stats,
)
from .norms import layernorm, rmsnorm, rmsnorm_plain
from .rope import rope_frequencies, rope_rotate

__all__ = [
    "attention_reference",
    "flash_attention",
    "flash_attention_bwd_plain",
    "flash_attention_plain",
    "flash_attention_with_stats",
    "layernorm",
    "rmsnorm",
    "rmsnorm_plain",
    "rope_frequencies",
    "rope_rotate",
]

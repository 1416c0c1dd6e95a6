"""How the port's flash attention gradient at B*H = 65535 (one launch of
each kernel) and 65536 (two: the head split) compares with the plain
versions, element by element, in bf16 (PyTorch/CUDA port, needs a card).

For each head count it runs `ray_tpu_torch.ops.flash_attention_with_stats`
forward and backward (the kernels) and the plain versions on the same
inputs, and prints, for dq, dk and dv, how many elements lie past the bf16
bar (|a - b| > 2e-2 + 2e-2 * |b|, as `torch.testing.assert_close` checks)
and the largest difference, in three comparisons:

- `kernels~plain(plain fwd)`: against the plain backward of the plain
  forward's o and lse;
- `kernels~plain(kernel fwd)`: against the plain backward of the kernels'
  own o and lse (what the tests hold the kernels to);
- `X~f32`: the kernels' gradient and the plain bf16 gradient each against
  the plain f32 gradient of the same inputs (the rounding each carries).

If the split were wrong, the counts at 65536 would differ in kind from
those at 65535, and the second launch's heads would carry them.

    python -m ray_tpu_torch.kernels.flash_heads_probe
"""

import json
import subprocess
import sys

import torch

from ray_tpu_torch.kernels.flash_bwd import flash_bwd_dkv, flash_bwd_dq
from ray_tpu_torch.kernels.flash_fwd import flash_fwd
from ray_tpu_torch.ops import (
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_attention_with_stats,
)

TOL = 2e-2
B, S, D = 1, 40, 32


def _randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)


def _past_bar(a, b):
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    past = diff > TOL + TOL * b.abs()
    heads = past.flatten(2).any(-1).nonzero()[:, 1] if past.any() else torch.zeros(0)
    return {"past": int(past.sum()), "of": past.numel(), "max_abs_diff": float(diff.max()),
            "heads_past": int(heads.numel()),
            "first_head_past": int(heads.min()) if heads.numel() else None}


def probe(H: int) -> dict:
    q, k, v = (_randn((B, H, S, D), torch.bfloat16, 40 + i).requires_grad_(True) for i in range(3))
    scale = D ** -0.5
    before = (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
    out, lse = flash_attention_with_stats(q, k, v, True)
    do = _randn(out.shape, out.dtype, 77)
    out.backward(do)
    torch.cuda.synchronize()
    launches = [b - a for a, b in zip(before, (flash_fwd.launches, flash_bwd_dq.launches,
                                               flash_bwd_dkv.launches))]
    grads = (q.grad, k.grad, v.grad)
    q, k, v = q.detach(), k.detach(), v.detach()
    o_p, lse_p = flash_attention_plain(q, k, v, True, return_lse=True)
    from_plain = flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, True, scale)
    from_kernel = flash_attention_bwd_plain(q, k, v, out.detach(), lse, do, True, scale)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o32, lse32 = flash_attention_plain(q32, k32, v32, True, return_lse=True)
    f32 = flash_attention_bwd_plain(q32, k32, v32, o32, lse32, do32, True, scale)
    rows = {}
    for name, want in (("kernels~plain(plain fwd)", from_plain), ("kernels~plain(kernel fwd)", from_kernel),
                       ("kernels~f32", f32), ("plain bf16~f32", None)):
        got = from_plain if want is None else grads
        want = f32 if want is None else want
        rows[name] = {t: _past_bar(g, w) for t, g, w in zip(("dq", "dk", "dv"), got, want)}
    return {"H": H, "launches fwd/dq/dkv": launches, "comparisons": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_heads_probe: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for H in (65535, 65536):
        print(json.dumps(probe(H)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port (`ray_tpu_torch`) on one NVIDIA H100.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases:
  1. device   card name and power limit (nvidia-smi), CUDA availability
  2. build    nvcc-build every kernel under ray_tpu_torch/kernels/csrc; fail
              if a bf16 flash kernel (forward, backward dQ or dK/dV, each
              head dim) spills or its wgmma are serialised (a C7513 note
              from ptxas, or a WARPGROUP.DEPBAR for every other HGMMA in the
              SASS), or has no HGMMA or UTMALDG; count its HGMMA / UTMALDG /
              UTMASTG instructions (cuobjdump); fail if an RMSNorm
              instantiation spills or is missing
  3. kernels  each kernel against its plain PyTorch version over a grid of
              shapes and dtypes, then timed beside its bound, its plain
              version and one library call: flash forward at llama-7b
              prefill shapes, flash backward (dQ with Delta, dK/dV) and the
              forward with lse at the gpt2-large training shape (each also
              checked against its plain version there), RMSNorm at the main
              path's rows (D=4096: N = 1, 4, 8, 64, 512, 2048, 16384 bf16,
              256 f32) beside a one-element kernel's launch floor; the
              attention op (forward and gradient) at a head dim the
              kernels pad (80 -> 128) and at a sequence split over several
              launches of each kernel (S=32769, D=128)
  4. parity   llama-7b widths, 2 layers, f32: make_generate and
              InferenceEngine on the card vs make_generate on the CPU
  5. train_parity  llama-7b widths, 2 layers, f32, remat "attn": loss and
              every gradient on the card vs the CPU, then the params after
              3 AdamW steps
  6. train    bench.py's step: gpt2-large, B=13 x S=1024, bf16 compute, f32
              master weights, remat "attn", AdamW(3e-4, wd 0.1, bf16 mu):
              tokens/s, step ms, MFU, peak memory, launches per step
  7. generate full llama-7b, bf16, seeded random weights: make_generate
  8. engine   full llama-7b, bf16: the continuous-batching engine with
              prefix caching, chunked prefill and speculative decoding
  9. runtime  the port's runtime in cluster mode on this machine: the GPU
              detected, CPU workers forked from a template that sees no card,
              an actor with num_gpus=1 that builds llama-7b bf16 (seed 0) and
              generates the generate phase's tokens, put/get of 256 MiB, a
              compiled-DAG round trip through a GPU actor

Prints progress lines, one `{"kernels": [...]}` line, the card line, and
last `{"ok": true, "device": {...}}`. Exits non-zero on any failure and
without a CUDA card. `--phases` runs a subset (no final ok line then).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PHASES = ("device", "build", "kernels", "parity", "train_parity", "train", "generate", "engine",
          "runtime")
H100_BF16_FLOPS = 989e12   # dense tensor-core peak, SXM
H100_F32_FLOPS = 67e12     # CUDA-core f32 peak, SXM
H100_BYTES_PER_S = 3.35e12
TOL = {"bf16": 2e-2, "f32_flash": 1e-4, "f32_rmsnorm": 1e-5}
# gpt2-large training shape of bench.py: B=13, H=20, S=1024, D=64.
TRAIN_ATTN = (13, 20, 1024, 64)

CARD = "unknown card"


def log(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int = 20, graph: bool = True):
    """(device ms, eager ms) per call of `fn`. Device time replays `iters`
    calls captured in one CUDA graph, so host launch overhead is out of it;
    eager time is the same loop launched from Python, host overhead in.
    With graph=False only the eager time is taken (device ms is None)."""
    import torch

    if not graph:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return None, start.elapsed_time(end) / iters
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / iters
    del graph
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return device_ms, start.elapsed_time(end) / iters


def profiled_ms(fn, iters: int = 10) -> float:
    """Device ms per call of `fn`: the summed durations of the device events
    torch.profiler records over `iters` calls, after 3 warm-up calls. For
    work a CUDA graph cannot capture; gaps between kernels are not in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    if us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return us / iters / 1e3


def compare(name: str, got, want, tol: float):
    """allclose-style check |got - want| <= tol * (1 + |want|); returns max
    abs error. Raises on a violation or a non-finite value."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (got - want).abs()
    max_abs = diff.max().item()
    max_rel = (diff / want.abs().clamp_min(1e-6)).max().item()
    bad = (diff > tol * (1 + want.abs())).sum().item()
    log(f"{name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} tol={tol:g} "
        f"{'FAIL' if bad else 'ok'}")
    if bad:
        raise AssertionError(f"{name}: {bad} elements outside tolerance {tol}")
    return max_abs


def _kernels() -> dict:
    """name -> kernel wrapper; each wrapper counts its launches in `.launches`."""
    from ray_tpu_torch.kernels.flash_bwd import flash_bwd_dkv, flash_bwd_dq
    from ray_tpu_torch.kernels.flash_fwd import flash_fwd
    from ray_tpu_torch.kernels.rmsnorm import rmsnorm_fwd

    return {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv,
            "rmsnorm": rmsnorm_fwd}


def reset_launches() -> None:
    for fn in _kernels().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _kernels().items()}


# ------------------------------------------------------------------ build
# The bf16 flash kernels that issue wgmma through TMA-fed rings: each is
# instantiated once per head dim.
BF16_FLASH = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")
HEAD_DIMS = (32, 64, 128, 256)


def instantiation(fn: str):
    """"flash_bwd_dq_bf16 D=64" for a mangled bf16 flash kernel name, else None."""
    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_bf16)ILi(\d+)E", fn)
    return f"{m.group(1)} D={m.group(2)}" if m else None


def serialised_wgmma(report: str) -> list:
    """ptxas's notes (C7513) that it serialised wgmma products, wherever they
    stand: only the bf16 flash kernels issue wgmma, and the note need not
    name its function on the same line."""
    return [line for line in report.splitlines() if "C7513" in line]


def spill_stores(report: str) -> dict:
    """bf16 flash (forward and backward) and RMSNorm entry function -> bytes
    of spill stores ptxas reports."""
    fn, spills = None, {}
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn and (instantiation(fn) or rmsnorm_instantiation(fn)):
            spills[fn] = int(m.group(1))
    return spills


def sass_counts(sass: str) -> dict:
    """Per bf16 flash instantiation ("flash_fwd_bf16 D=128", ...): its
    HGMMA, TMA (UTMALDG, UTMASTG) and WARPGROUP.DEPBAR instructions in
    cuobjdump's SASS."""
    ops = {"HGMMA": r"\bHGMMA\b", "UTMALDG": r"\bUTMALDG\b", "UTMASTG": r"\bUTMASTG\b",
           "DEPBAR": r"\bWARPGROUP\.DEPBAR\b"}
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = instantiation(line)
            if cur:
                counts[cur] = dict.fromkeys(ops, 0)
        elif cur:
            for op, pat in ops.items():
                if re.search(pat, line):
                    counts[cur][op] += 1
    return counts


def check_sass(counts: dict) -> None:
    """Tensor-core and TMA instructions in every instantiation, and products
    that are not serialised: a serialised wgmma pipeline waits
    (WARPGROUP.DEPBAR) after every HGMMA, a pipelined one a few times per
    stream tile."""
    if not counts or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in counts.values()):
        raise AssertionError(f"bf16 flash kernel without HGMMA or UTMALDG: {counts}")
    serial = {d: c for d, c in counts.items() if 2 * c["DEPBAR"] >= c["HGMMA"]}
    if serial:
        raise AssertionError(f"bf16 flash kernel with a WARPGROUP.DEPBAR for every other HGMMA or more "
                             f"(serialised wgmma): {serial}")


RMS_TYPES = {"2": "bf16", "4": "f32"}


def rmsnorm_instantiation(fn: str):
    """"rmsnorm_regs x=bf16 w=f32 NV=2" / "rmsnorm_rows x=f32 w=f32 vector"
    for a mangled RMSNorm kernel name, else None."""
    m = re.search(r"(rmsnorm_(?:regs|rows))ILi(\d)ELi(\d)E(?:Li(\d)E|Lb([01])E)", fn)
    if not m:
        return None
    kind = f"NV={m.group(4)}" if m.group(4) else ("vector" if m.group(5) == "1" else "scalar")
    return f"{m.group(1)} x={RMS_TYPES[m.group(2)]} w={RMS_TYPES[m.group(3)]} {kind}"


def rmsnorm_expected() -> list:
    """Every RMSNorm instantiation the build must hold: the register kernel
    for each x and w dtype and NV in (1, 2), the two-pass kernel for each
    dtype pair, vector and scalar."""
    pairs = [(x, w) for x in ("bf16", "f32") for w in ("bf16", "f32")]
    return ([f"rmsnorm_regs x={x} w={w} NV={nv}" for x, w in pairs for nv in (1, 2)]
            + [f"rmsnorm_rows x={x} w={w} {kind}" for x, w in pairs for kind in ("vector", "scalar")])


def missing_rmsnorm(found) -> list:
    """The RMSNorm instantiations not among the mangled names `found`."""
    names = {rmsnorm_instantiation(fn) for fn in found}
    return [k for k in rmsnorm_expected() if k not in names]


def missing_instantiations(found) -> list:
    """The bf16 flash instantiations (kernel x head dim) not among `found`."""
    found = set(found)
    return [f"{k} D={d}" for k in BF16_FLASH for d in HEAD_DIMS if f"{k} D={d}" not in found]


def check_build(build) -> None:
    """What ptxas and the SASS say about every bf16 flash kernel, forward and
    backward: no spills, no serialised wgmma, and tensor-core (HGMMA) and
    TMA (UTMALDG) instructions in every instantiation."""
    report = build.ptxas_report()
    print(report, flush=True)
    spills, serial = spill_stores(report), serialised_wgmma(report)
    missing = missing_instantiations(instantiation(fn) for fn in spills)
    missing += missing_rmsnorm(spills)
    if missing or any(spills.values()) or serial:
        raise AssertionError(f"bf16 flash and RMSNorm kernels: spill stores {spills}, serialised wgmma {serial}, "
                             f"not in the ptxas report {missing}")
    log(f"build: bf16 flash forward and backward and RMSNorm, {len(spills)} instantiations, no spills, "
        f"no C7513 note")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        log("build: no cuobjdump in the toolkit: SASS instruction counts not measured")
        return
    sass = subprocess.run([cuobjdump, "--dump-sass", str(build.build_dir() / build.LIB_NAME)],
                          capture_output=True, text=True, check=True).stdout
    counts = sass_counts(sass)
    log(f"build: SASS of the bf16 flash kernels (cuobjdump): {counts}")
    missing = missing_instantiations(counts)
    if missing:
        raise AssertionError(f"bf16 flash instantiations not in the SASS: {missing}")
    check_sass(counts)


# ---------------------------------------------------------------- kernels
def phase_kernels(results: dict) -> None:
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.kernels.flash_fwd import flash_fwd
    from ray_tpu_torch.kernels.rmsnorm import rmsnorm_fwd
    from ray_tpu_torch.ops.attention import flash_attention_plain
    from ray_tpu_torch.ops.norms import rmsnorm_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    flash_cases = [(1024, 1024, True), (1024, 1024, False), (200, 200, True),
                   (200, 200, False), (1, 128, True), (64, 192, True)]
    for D in (32, 64, 128, 256):
        for dname, dt in dtypes.items():
            tol = TOL["bf16"] if dname == "bf16" else TOL["f32_flash"]
            for S, Skv, causal in flash_cases:
                q = randn(1, 2, S, D, dtype=dt)
                k = randn(1, 2, Skv, D, dtype=dt)
                v = randn(1, 2, Skv, D, dtype=dt)
                out, lse = flash_fwd(q, k, v, causal, D ** -0.5, True)
                torch.cuda.synchronize()
                ref, ref_lse = flash_attention_plain(q, k, v, causal, D ** -0.5, return_lse=True)
                tag = f"flash D={D} {dname} S={S} Skv={Skv} causal={causal}"
                compare(tag + " out", out, ref, tol)
                compare(tag + " lse", lse.reshape(ref_lse.shape), ref_lse, tol)
    # The shapes and layout the generate phase gives the kernel: q and k
    # contiguous after RoPE, v a strided view of the qkv projection.
    qkv = randn(4, 128, 3, 32, 128, dtype=torch.bfloat16)
    q, k = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(2))
    v = qkv[:, :, 2].transpose(1, 2)
    compare("flash main-path B=4 H=32 S=128 D=128 bf16 causal, strided v",
            flash_fwd(q, k, v, True, 128 ** -0.5)[0],
            flash_attention_plain(q, k, v, True, 128 ** -0.5), TOL["bf16"])

    _check_flash_bwd(randn, dtypes)
    _check_flash_op_repairs(randn)

    for dname, dt in dtypes.items():
        tol = TOL["bf16"] if dname == "bf16" else TOL["f32_rmsnorm"]
        for wname, wt in dtypes.items():  # the weight is read in its own dtype
            for N in (1, 4, 7, 64, 512, 4096):  # 4, 64, 512: decode, engine chunk, prefill rows
                for D in (4096, 768):
                    x = randn(N, D, dtype=dt) * 3
                    w = (1 + 0.1 * randn(D, dtype=torch.float32)).to(wt)
                    y = rmsnorm_fwd(x, w)
                    torch.cuda.synchronize()
                    compare(f"rmsnorm N={N} D={D} x {dname} w {wname}", y, rmsnorm_plain(x, w), tol)

    # Timing at llama-7b prefill shapes (bf16): B=4, H=32, S=512, D=128.
    B, H, S, D = 4, 32, 512, 128
    q, k, v = (randn(B, H, S, D, dtype=torch.bfloat16) for _ in range(3))
    scale = D ** -0.5
    err = compare("flash timed shape", flash_fwd(q, k, v, True, scale)[0],
                  flash_attention_plain(q, k, v, True, scale), TOL["bf16"])
    pairs = B * H * S * (S + 1) // 2                   # unmasked (query, key) pairs
    ops_s = 4 * D * pairs / H100_BF16_FLOPS
    bytes_s = 4 * B * H * S * D * 2 / H100_BYTES_PER_S   # q, k, v read; o written
    results["flash_fwd"] = dict(
        name="flash_fwd", route="cuda", source="ray_tpu_torch/kernels/csrc/flash_fwd.cu",
        replaces="ray_tpu/ops/attention.py:220", max_abs_err=err,
        bound_ms=max(ops_s, bytes_s) * 1e3, bound_by="operations" if ops_s >= bytes_s else "bytes",
        shape=f"B={B} H={H} S={S} D={D} bf16 causal",
        **_times(lambda: flash_fwd(q, k, v, True, scale),
                 lambda: flash_attention_plain(q, k, v, True, scale),
                 lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
    )

    _time_rmsnorm(results, randn)
    _time_flash_train_shape(results, randn)
    for r in results.values():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"{r['name']} at {r['shape']}: kernel {r['ms']:.4f} ms (eager loop {r['eager_ms']:.4f}), "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"library {lib}")

    # The generate phase's own shapes: prefill attention and norms, decode norms.
    q, k, v = (randn(4, 32, 128, 128, dtype=torch.bfloat16) for _ in range(3))
    t = _times(lambda: flash_fwd(q, k, v, True, scale), lambda: flash_attention_plain(q, k, v, True, scale),
               lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    log(f"flash_fwd at B=4 H=32 S=128 D=128 bf16 causal: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms")
    results["flash_fwd"].update(generate_shape_ms=t["ms"], generate_shape_library_ms=t["library_ms"])
    # A long prompt, where the forward is bound by tensor-core operations
    # (kernel against the library only: the plain version would hold 2 GB of
    # f32 logits per call).
    q, k, v = (randn(4, 32, 2048, 128, dtype=torch.bfloat16) for _ in range(3))
    long_ms = cuda_ms(lambda: flash_fwd(q, k, v, True, scale))[0]
    long_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))[0]
    log(f"flash_fwd at B=4 H=32 S=2048 D=128 bf16 causal: kernel {long_ms:.4f} ms, library {long_lib_ms:.4f} ms")
    results["flash_fwd"].update(long_shape_ms=long_ms, long_shape_library_ms=long_lib_ms)
    del q, k, v
    torch.cuda.empty_cache()


# RMSNorm's timed rows at D=4096: decode (1, 4, 8), an engine prefill chunk
# (64), generate's prefill (512), the table's earlier shape (2048, L2-warm),
# a shape beyond the 50 MB L2 (16384: 128 MiB in, 128 MiB out) where the
# bound is HBM bandwidth, and train_parity's f32 rows (256).
RMS_SHAPES = ((1, "bf16"), (4, "bf16"), (8, "bf16"), (64, "bf16"), (512, "bf16"), (2048, "bf16"),
              (16384, "bf16"), (256, "f32"))
RMS_RECORD_N = 16384
L2_BYTES = 50e6


def _time_rmsnorm(results: dict, randn) -> None:
    """RMSNorm at RMS_SHAPES: checked against the plain version, then timed
    by graph replay and eagerly, beside `F.rms_norm`, the bytes bound (x
    read, y written, the weight at its own dtype) and the launch floor
    (graph replay of a one-element torch kernel)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.kernels import rmsnorm as rk
    from ray_tpu_torch.ops.norms import rmsnorm_plain

    one = torch.zeros(1, device="cuda")
    floor_ms = cuda_ms(lambda: one.add_(1))[0]
    log(f"launch floor: a one-element torch kernel {floor_ms:.4f} ms per call (graph replay)")
    D, rows, worst = 4096, [], 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for N, dname in RMS_SHAPES:
        dt = torch.bfloat16 if dname == "bf16" else torch.float32
        tol = TOL["bf16"] if dname == "bf16" else TOL["f32_rmsnorm"]
        x = randn(N, D, dtype=dt)
        w = (1 + 0.1 * randn(D, dtype=torch.float32)).to(dt)
        want = rmsnorm_plain(x, w)
        err = compare(f"rmsnorm timed N={N} D={D} {dname}", rk.rmsnorm_fwd(x, w), want, tol)
        worst = max(worst, err)
        del want
        nbytes = 2 * N * D * x.element_size() + D * w.element_size()
        bytes_s, ops_s = nbytes / H100_BYTES_PER_S, 4 * N * D / H100_F32_FLOPS
        q = rk.plan(N, D, dt, D, x.data_ptr(), x.data_ptr(), sms, w.data_ptr())
        ms, eager_ms = cuda_ms(lambda: rk.rmsnorm_fwd(x, w))
        row = dict(
            N=N, D=D, dtype=dname, ms=ms, eager_ms=eager_ms,
            library_ms=cuda_ms(lambda: F.rms_norm(x, (D,), w, 1e-6))[0],
            bound_ms=max(bytes_s, ops_s) * 1e3, bound_by="operations" if ops_s > bytes_s else "bytes",
            l2_warm=nbytes < L2_BYTES, max_abs_err=err,
            plan=f"{q.path} T={q.threads_per_row} R={q.rows_per_cta} NV={q.nv} grid={q.grid}")
        if N == RMS_RECORD_N:
            row["plain_ms"] = cuda_ms(lambda: rmsnorm_plain(x, w), iters=5)[0]
            # A device copy of x's bytes: what any kernel that reads x once and
            # writes y once reaches on this card at this size.
            out = torch.empty_like(x)
            row["copy_ms"] = cuda_ms(lambda: out.copy_(x))[0]
            log(f"rmsnorm N={N}: a plain copy of the same bytes (torch copy_) {row['copy_ms']:.4f} ms, "
                f"{row['bound_ms'] / row['copy_ms']:.1%} of the bound")
            del out
        rows.append(row)
        log(f"rmsnorm N={N} D={D} {dname}: {ms:.4f} ms (eager {eager_ms:.4f}), "
            f"F.rms_norm {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{row['bound_ms'] / ms:.1%} of it{', L2-warm' if row['l2_warm'] else ''}), launch floor "
            f"{floor_ms:.4f} ms; plan {row['plan']}")
        del x
    torch.cuda.empty_cache()
    rec = next(r for r in rows if r["N"] == RMS_RECORD_N)
    results["rmsnorm"] = dict(
        name="rmsnorm", route="cuda", source="ray_tpu_torch/kernels/csrc/rmsnorm.cu",
        replaces="ray_tpu/ops/norms.py:30", max_abs_err=worst, bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
        shape=f"N={RMS_RECORD_N} D={D} bf16 x, bf16 w", ms=rec["ms"], eager_ms=rec["eager_ms"],
        plain_ms=rec["plain_ms"], library_ms=rec["library_ms"], copy_ms=rec["copy_ms"], shapes=rows,
        launch_floor_ms=floor_ms,
    )


def _times(kernel, plain, library) -> dict:
    ms, eager_ms = cuda_ms(kernel)
    return dict(ms=ms, eager_ms=eager_ms, plain_ms=cuda_ms(plain, iters=5)[0],
                library_ms=cuda_ms(library)[0] if library is not None else None)


def _check_bwd_case(tag: str, q, k, v, do, causal: bool, tol: float, strided_do=None) -> list:
    """dQ, Delta (the dQ kernel's), dK and dV of the two backward kernels,
    launched as `flash_bwd` launches them, against the plain backward and
    rowsum(dO o O); returns their max abs errors. `strided_do`, when given,
    is the view the kernels read (do is its contiguous copy)."""
    import torch

    from ray_tpu_torch.kernels.flash_bwd import flash_bwd_dkv, flash_bwd_dq
    from ray_tpu_torch.kernels.flash_fwd import flash_fwd
    from ray_tpu_torch.ops.attention import flash_attention_bwd_plain

    scale = q.shape[-1] ** -0.5
    kdo = do if strided_do is None else strided_do
    o, lse = flash_fwd(q, k, v, causal, scale, True)
    dq, delta = flash_bwd_dq(q, k, v, o, kdo, lse, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, kdo, lse, delta, causal, scale)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    want_delta = (do.float() * o.float()).sum(-1).reshape(delta.shape)
    return [compare(f"flash bwd {name} {tag}", a, w, tol)
            for name, a, w in zip(("dq", "delta", "dk", "dv"), (dq, delta, dk, dv), (want[0], want_delta, *want[1:]))]


def _check_flash_bwd(randn, dtypes) -> None:
    """dq, Delta, dk, dv of the two backward kernels against the plain
    backward, over head dims, dtypes and tile edges."""
    import torch

    cases = [(1024, 1024, True), (1024, 1024, False), (200, 200, True), (64, 192, True)]
    for D in (32, 64, 128, 256):
        for dname, dt in dtypes.items():
            tol = TOL["bf16"] if dname == "bf16" else TOL["f32_flash"]
            for S, Skv, causal in cases:
                q, do = randn(1, 2, S, D, dtype=dt), randn(1, 2, S, D, dtype=dt)
                k, v = randn(1, 2, Skv, D, dtype=dt), randn(1, 2, Skv, D, dtype=dt)
                _check_bwd_case(f"D={D} {dname} S={S} Skv={Skv} causal={causal}", q, k, v, do, causal, tol)
    # dO as autograd may hand it over: a transposed view, not contiguous.
    B, H, S, D = 2, 4, 256, 64
    q, k, v = (randn(B, H, S, D, dtype=torch.bfloat16) for _ in range(3))
    do = randn(B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    _check_bwd_case(f"strided dO B={B} H={H} S={S} D={D} bf16", q, k, v, do.contiguous(), True, TOL["bf16"],
                    strided_do=do)


def _check_flash_op_repairs(randn) -> None:
    """The attention op (forward and gradient, so the three flash kernels)
    against the plain versions at shapes one launch of the kernels could
    not take: a head dim the kernels are not compiled for (zero-padded to
    the next), and a sequence past every tile table (each kernel split into
    several launches; the plain side holds several 4 GB f32 matrices)."""
    import torch

    from ray_tpu_torch.kernels.flash_bwd import flash_bwd_dkv, flash_bwd_dq
    from ray_tpu_torch.kernels.flash_fwd import flash_fwd
    from ray_tpu_torch.ops.attention import (flash_attention_bwd_plain, flash_attention_plain,
                                             flash_attention_with_stats)

    for tag, (B, H, S, D), want in (("padded D=80", (2, 3, 200, 80), (1, 1, 1)),
                                    ("split S=32769 D=128", (1, 1, 32769, 128), (2, 3, 3))):
        q, k, v = (randn(B, H, S, D, dtype=torch.bfloat16).requires_grad_(True) for _ in range(3))
        do = randn(B, H, S, D, dtype=torch.bfloat16)
        before = (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
        out, lse = flash_attention_with_stats(q, k, v, True)
        out.backward(do)
        torch.cuda.synchronize()
        n = tuple(a - b for a, b in zip((flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches),
                                        before))
        if n != want:
            raise AssertionError(f"flash op {tag}: launches (fwd, dq, dkv) {n}, want {want}")
        with torch.no_grad():  # the gradient against the plain backward of the kernels' (o, lse)
            ref, ref_lse = flash_attention_plain(q, k, v, True, return_lse=True)
            compare(f"flash op {tag} out", out.detach(), ref, TOL["bf16"])
            compare(f"flash op {tag} lse", lse, ref_lse, TOL["bf16"])
            del ref, ref_lse
            grads = flash_attention_bwd_plain(q, k, v, out.detach(), lse, do, True, D ** -0.5)
            for name, x, w in zip(("dq", "dk", "dv"), (q, k, v), grads):
                compare(f"flash op {tag} {name}", x.grad, w, TOL["bf16"])
        del q, k, v, do, out, lse, grads
        torch.cuda.empty_cache()
        log(f"flash op {tag}: launches (fwd, dq, dkv) {n}, matches the plain versions")


def _time_flash_train_shape(results: dict, randn) -> None:
    """The flash kernels at the gpt2-large training shape (bf16, causal):
    dQ (with Delta) and dK/dV alone, the pair against the backward of
    scaled_dot_product_attention, and the forward with lse."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.kernels.flash_bwd import flash_bwd, flash_bwd_dkv, flash_bwd_dq
    from ray_tpu_torch.kernels.flash_fwd import flash_fwd
    from ray_tpu_torch.ops.attention import flash_attention_bwd_plain, flash_attention_plain

    B, H, S, D = TRAIN_ATTN
    scale = D ** -0.5
    q, k, v, do = (randn(B, H, S, D, dtype=torch.bfloat16) for _ in range(4))
    o, lse = flash_fwd(q, k, v, True, scale, True)
    ref, ref_lse = flash_attention_plain(q, k, v, True, scale, return_lse=True)
    fwd_err = max(compare("flash training shape out", o, ref, TOL["bf16"]),
                  compare("flash training shape lse", lse.reshape(ref_lse.shape), ref_lse, TOL["bf16"]))
    results["flash_fwd"]["max_abs_err"] = max(results["flash_fwd"]["max_abs_err"], fwd_err)
    del ref, ref_lse
    errs = _check_bwd_case(f"training shape B={B} H={H} S={S} D={D} bf16", q, k, v, do, True, TOL["bf16"])
    # The strided dO autograd hands over at this shape: [B, S, H, D] seen as [B, H, S, D].
    do_t = do.transpose(1, 2).contiguous().transpose(1, 2)
    errs = [max(a, b) for a, b in zip(errs, _check_bwd_case(
        f"training shape, strided dO B={B} H={H} S={S} D={D} bf16", q, k, v, do, True, TOL["bf16"],
        strided_do=do_t))]
    del do_t
    delta = flash_bwd_dq(q, k, v, o, do, lse, True, scale)[1]
    pairs = B * H * S * (S + 1) // 2  # unmasked (query, key) pairs
    tile = B * H * S * D * 2          # one bf16 [B, H, S, D] tensor
    rows = B * H * S * 4              # one f32 [B*H, S] row vector (lse, Delta)
    plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, True, scale), iters=3)[0]

    # The library's backward: scaled_dot_product_attention's, timed on the
    # device by the profiler (autograd's backward of a forward run outside
    # the graph is not captured in one); its eager loop, host time in, is
    # logged beside it. The port's backward pair (Delta in its dQ kernel) is
    # timed both ways too.
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    library_bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)  # noqa: E731
    library_bwd_ms = profiled_ms(library_bwd)
    library_bwd_eager_ms = cuda_ms(library_bwd, graph=False)[1]
    pair = lambda: flash_bwd(q, k, v, o, lse, do, True, scale)  # noqa: E731
    pair_ms, pair_profiled_ms = cuda_ms(pair)[0], profiled_ms(pair)
    for name, fn, flops, nbytes, err in (
        # q, k, v, o, dO read, dq written; lse read, Delta written
        ("flash_bwd_dq", lambda: flash_bwd_dq(q, k, v, o, do, lse, True, scale),
         6 * D * pairs, 6 * tile + 2 * rows, max(errs[:2])),
        # q, k, v, dO read, dk, dv written; lse and Delta read
        ("flash_bwd_dkv", lambda: flash_bwd_dkv(q, k, v, do, lse, delta, True, scale),
         8 * D * pairs, 6 * tile + 2 * rows, max(errs[2:])),
    ):
        ops_s, bytes_s = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
        ms, eager_ms = cuda_ms(fn)
        results[name] = dict(
            name=name, route="cuda", source="ray_tpu_torch/kernels/csrc/flash_bwd.cu",
            replaces="ray_tpu/ops/attention.py:477" if name == "flash_bwd_dq" else "ray_tpu/ops/attention.py:500",
            max_abs_err=err, bound_ms=max(ops_s, bytes_s) * 1e3,
            bound_by="operations" if ops_s >= bytes_s else "bytes",
            shape=f"B={B} H={H} S={S} D={D} bf16 causal", ms=ms, eager_ms=eager_ms,
            plain_ms=plain_ms, library_ms=library_bwd_ms, pair_ms=pair_ms,
            pair_profiled_ms=pair_profiled_ms, library_eager_ms=library_bwd_eager_ms,
        )
    log(f"flash backward at the training shape B={B} H={H} S={S} D={D} bf16 causal: dQ (with Delta) + dK/dV "
        f"{pair_ms:.4f} ms (graph replay), {pair_profiled_ms:.4f} ms (profiler device time); "
        f"scaled_dot_product_attention backward {library_bwd_ms:.4f} ms (profiler device time), "
        f"{library_bwd_eager_ms:.4f} ms (eager loop, host time in); plain {plain_ms:.4f} ms "
        f"(plain computes dq, dk and dv together: it is the plain_ms of both rows)")

    ops_s = 4 * D * pairs / H100_BF16_FLOPS
    bytes_s = (4 * tile + rows) / H100_BYTES_PER_S  # q, k, v read; o and lse written
    t = _times(lambda: flash_fwd(q, k, v, True, scale, True),
               lambda: flash_attention_plain(q, k, v, True, scale, return_lse=True),
               lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    bound_by = "operations" if ops_s >= bytes_s else "bytes"
    log(f"flash_fwd with lse at the training shape: kernel {t['ms']:.4f} ms, bound "
        f"{max(ops_s, bytes_s) * 1e3:.4f} ms ({bound_by}), plain "
        f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms (scaled_dot_product_attention, no lse)")
    results["flash_fwd"].update(
        train_shape=f"B={B} H={H} S={S} D={D} bf16 causal, lse", train_shape_ms=t["ms"],
        train_shape_bound_ms=max(ops_s, bytes_s) * 1e3, train_shape_bound_by=bound_by,
        train_shape_plain_ms=t["plain_ms"], train_shape_library_ms=t["library_ms"])


# ----------------------------------------------------------------- parity
def _drain(engine, max_steps: int = 10_000) -> int:
    n = 0
    while engine.scheduler.has_work():
        engine.step()
        n += 1
        if n >= max_steps:
            raise AssertionError("engine did not drain")
    return n


def _finite_guard(engine, forwards: dict | None = None) -> None:
    """Wrap the engine's three device functions so every logits tensor they
    return is checked finite; each call adds one to `forwards["n"]`."""
    def wrap(fn):
        def checked(*args):
            if forwards is not None:
                forwards["n"] += 1
            logits, kv = fn(*args)
            if not bool(logits.isfinite().all()):
                raise AssertionError(f"{fn.__name__}: non-finite logits")
            return logits, kv
        return checked

    engine._prefill = wrap(engine._prefill)
    engine._decode = wrap(engine._decode)
    engine._verify = wrap(engine._verify)


def phase_parity() -> None:
    import torch

    from ray_tpu_torch.models.gpt import init_params, llama_7b, make_generate, prefill, init_cache
    from ray_tpu_torch.serve.engine.engine import EngineOptions, InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_7b(n_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cuda", dtype=torch.float32)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    gen = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    N = 8

    logits_gpu, _ = prefill(params, prompts.cuda(), cfg, init_cache(cfg, 2, 32, device="cuda"))
    logits_cpu, _ = prefill(cpu_params, prompts, cfg, init_cache(cfg, 2, 32, device="cpu"))
    diff = (logits_gpu.cpu() - logits_cpu).abs().max().item()
    log(f"parity f32 llama-7b widths L=2: first prefill max |logit diff| gpu-kernel vs cpu-plain = {diff:.3e}")

    toks_gpu = make_generate(cfg, N)(params, prompts.cuda()).cpu().tolist()
    toks_cpu = make_generate(cfg, N)(cpu_params, prompts).tolist()
    engine = InferenceEngine(cfg, params, EngineOptions(num_blocks=64, block_size=16, max_num_seqs=4),
                             device="cuda")
    _finite_guard(engine)
    rids = [engine.submit(p, N) for p in prompts.tolist()]
    _drain(engine)
    toks_eng = [list(engine.stream(r)) for r in rids]
    log(f"parity greedy tokens: generate(gpu)={toks_gpu} engine(gpu)={toks_eng} generate(cpu)={toks_cpu}")
    if not (toks_gpu == toks_cpu == toks_eng):
        raise AssertionError("greedy tokens differ between the kernel path, the engine and the CPU")
    if len({t for row in toks_cpu for t in row}) <= 3:
        raise AssertionError("degenerate greedy decode: parity proves nothing")
    del params, cpu_params, engine
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ train
def _update_rel_diff(after_a: dict, after_b: dict, before: dict) -> float:
    """||(a - p0) - (b - p0)|| / ||b - p0|| over every param: how far two
    runs' total updates differ, relative to the update."""
    num = sum(float((after_a[k].detach().cpu() - after_b[k].detach()).double().square().sum())
              for k in before)
    den = sum(float((after_b[k].detach() - before[k]).double().square().sum()) for k in before)
    return (num / max(den, 1e-300)) ** 0.5


def phase_train_parity(launches: dict) -> None:
    """llama-7b widths, 2 layers, f32, TF32 off, remat "attn": one step's
    loss and every gradient on the card (kernels) against the CPU (plain),
    then the params after 3 AdamW steps (bench.py's hyperparameters)."""
    import torch

    from ray_tpu_torch.models.gpt import init_params, llama_7b, make_train_step
    from ray_tpu_torch.optim import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_7b(n_layers=2, dtype=torch.float32, remat=True, remat_policy="attn")
    cpu = init_params(cfg, seed=1, device="cpu")
    start = {k: v.clone() for k, v in cpu.items()}
    gpu = {k: v.to("cuda") for k, v in cpu.items()}
    tokens = torch.randint(0, cfg.vocab_size, (2, 129), generator=torch.Generator().manual_seed(5))
    hyper = dict(lr=3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)
    steps = {"cpu": make_train_step(cfg, AdamW(cpu.values(), **hyper)),
             "gpu": make_train_step(cfg, AdamW(gpu.values(), **hyper))}
    batches = {"cpu": {"tokens": tokens}, "gpu": {"tokens": tokens.cuda()}}
    t0 = time.perf_counter()
    _, m_cpu = steps["cpu"](cpu, batches["cpu"])
    t_cpu = time.perf_counter() - t0
    reset_launches()
    _, m_gpu = steps["gpu"](gpu, batches["gpu"])
    torch.cuda.synchronize()
    first = read_launches()
    loss_d = abs(m_gpu["loss"].item() - m_cpu["loss"].item()) / abs(m_cpu["loss"].item())
    worst, worst_name = 0.0, ""
    for k, p in cpu.items():
        if p.grad is None:  # RMSNorm biases: unused on both sides
            if gpu[k].grad is not None:
                raise AssertionError(f"train_parity: {k} has a gradient on the card only")
            continue
        rel = (gpu[k].grad.cpu() - p.grad).abs().max().item() / max(p.grad.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, k
    log(f"train_parity f32 llama-7b widths L=2 B=2 S=128 remat=attn: loss gpu {m_gpu['loss'].item():.6f} "
        f"cpu {m_cpu['loss'].item():.6f} (rel diff {loss_d:.2e}); grads: worst max|d|/max|ref| "
        f"{worst:.2e} ({worst_name}); grad_norm gpu {m_gpu['grad_norm'].item():.6f} cpu "
        f"{m_cpu['grad_norm'].item():.6f}; one CPU step {t_cpu:.1f} s; launches in the step {first}")
    if loss_d > 1e-5 or worst > 1e-4:
        raise AssertionError(f"train_parity: loss rel diff {loss_d:.2e} (tol 1e-5) or grad {worst_name} "
                             f"rel diff {worst:.2e} (tol 1e-4)")
    for _ in range(2):
        steps["cpu"](cpu, batches["cpu"])
        steps["gpu"](gpu, batches["gpu"])
    torch.cuda.synchronize()
    launches["train_parity"] = read_launches()
    upd = _update_rel_diff(gpu, cpu, start)
    max_d = max((gpu[k].detach().cpu() - cpu[k].detach()).abs().max().item() for k in cpu)
    log(f"train_parity after 3 AdamW steps: ||update gpu - update cpu|| / ||update cpu|| = {upd:.2e}, "
        f"max |param gpu - param cpu| = {max_d:.2e} (lr {hyper['lr']}); launches over the 3 steps "
        f"{launches['train_parity']}")
    if upd > 1e-3:
        raise AssertionError(f"train_parity: params after 3 steps differ by {upd:.2e} of the update (tol 1e-3)")
    L = cfg.n_layers
    want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    if any(first[k] != n for k, n in want.items()) or first["rmsnorm"] <= 0:
        raise AssertionError(f"train_parity launches per step {first}, want {want} and rmsnorm > 0")
    del cpu, gpu, steps
    torch.cuda.empty_cache()


def phase_train(launches: dict) -> None:
    """bench.py's training step on the port: gpt2-large, B=13 x S=1024."""
    import torch

    from ray_tpu_torch.models.gpt import gpt2_large, init_params, make_train_step
    from ray_tpu_torch.optim import AdamW

    B, S = 13, 1024
    cfg = gpt2_large(max_seq=S, attn_impl="flash", remat=True, remat_policy="attn")
    params = init_params(cfg, seed=0, device="cuda")  # f32 master weights
    step = make_train_step(cfg, AdamW(params.values(), lr=3e-4, weight_decay=0.1,
                                      mu_dtype=torch.bfloat16))
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    batch = {"tokens": tokens}
    t0 = time.perf_counter()
    _, metrics = step(params, batch)
    first_loss = metrics["loss"].item()
    step(params, batch)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    n_steps, L = 10, cfg.n_layers
    per_step = []
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        before = read_launches()
        _, metrics = step(params, batch)
        per_step.append({k: n - before[k] for k, n in read_launches().items()})
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_steps
    launches["train"] = read_launches()
    final_loss = metrics["loss"].item()
    tok_s = B * S / dt
    mfu = cfg.flops_per_token(S) * tok_s / H100_BF16_FLOPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train gpt2-large B={B} S={S} bf16 compute, f32 master, remat=attn, AdamW bf16 mu: "
        f"{tok_s:.1f} tokens/s, step {dt * 1e3:.2f} ms, train_mfu {mfu:.4f} (of 989 TFLOP/s bf16), "
        f"peak memory {peak:.2f} GiB, loss {first_loss:.4f} (step 1) -> {final_loss:.4f} (step 12), "
        f"grad_norm {metrics['grad_norm'].item():.4f}, {cfg.n_params / 1e6:.1f} M params, "
        f"warm-up 2 steps {warm:.1f} s; launches over {n_steps} steps {launches['train']}")
    if not (math.isfinite(final_loss) and final_loss < first_loss):
        raise AssertionError(f"train: loss {first_loss} -> {final_loss} is not finite and falling")
    want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L, "rmsnorm": 0}
    for i, n in enumerate(per_step):
        if n != want:
            raise AssertionError(f"train step {i}: launches {n}, want {want}")
    _profile(f"train gpt2-large B={B} S={S}, one step", lambda: step(params, batch))
    del params, step
    torch.cuda.empty_cache()


# --------------------------------------------------------- generate/engine
def _llama_params():
    import torch

    from ray_tpu_torch.models.gpt import init_params, llama_7b

    cfg = llama_7b()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.values())
    log(f"llama-7b bf16 random weights: {n / 1e9:.3f} B params in {time.perf_counter() - t0:.1f} s")
    return cfg, params


# make_generate's shape in the generate and runtime phases: B, prompt, new tokens.
GENERATE_SHAPE = (4, 128, 32)


def _timed_generate(cfg, params, prompt, n: int):
    """make_generate(cfg, n) on prompt after a warm-up call: (tokens, wall
    s, launches per kernel in the timed call)."""
    import torch

    from ray_tpu_torch.models.gpt import make_generate

    make_generate(cfg, 2)(params, prompt)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    gen = make_generate(cfg, n)
    reset_launches()
    t0 = time.perf_counter()
    toks = gen(params, prompt)
    torch.cuda.synchronize()
    return toks, time.perf_counter() - t0, read_launches()


def _check_generate(cfg, toks, counts: dict, where: str) -> None:
    B, _, N = GENERATE_SHAPE
    L = cfg.n_layers
    if tuple(toks.shape) != (B, N) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{where}: bad generate output {tuple(toks.shape)}")
    nf, nr = counts["flash_fwd"], counts["rmsnorm"]
    if nf != L or nr != (2 * L + 1) * N:
        raise AssertionError(f"{where}: launch counts flash={nf} (want {L}), rmsnorm={nr} "
                             f"(want {(2 * L + 1) * N})")


def phase_generate(cfg, params, launches: dict) -> dict:
    import torch

    from ray_tpu_torch.kernels.flash_fwd import flash_fwd
    from ray_tpu_torch.kernels.rmsnorm import rmsnorm_fwd
    from ray_tpu_torch.models.gpt import make_generate

    B, S0, N = GENERATE_SHAPE
    prompt = torch.randint(0, cfg.vocab_size, (B, S0), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.reset_peak_memory_stats()
    toks, wall, launches["generate"] = _timed_generate(cfg, params, prompt, N)
    log(f"generate llama-7b bf16 B={B} prompt={S0} new={N}: {B * N / wall:.1f} tokens/s, "
        f"{wall * 1e3:.1f} ms wall, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches flash={flash_fwd.launches} rmsnorm={rmsnorm_fwd.launches}")
    _check_generate(cfg, toks, launches["generate"], "generate")
    L = cfg.n_layers

    # Device events per forward: every forward runs 2L+1 norms, one RMSNorm
    # launch each, so the profiled call's forwards are its launches / (2L+1).
    before = rmsnorm_fwd.launches
    events = _profile("generate llama-7b bf16 B=4 prompt=128 new=8", lambda: make_generate(cfg, 8)(params, prompt))
    forwards = (rmsnorm_fwd.launches - before) // (2 * L + 1)
    if events:
        log(f"generate profile: {events} device events over {forwards} forwards (prefill + decode steps) = "
            f"{events / forwards:.1f} per forward")
    return {"prompt": prompt.cpu(), "tokens": toks.cpu(), "tokens_per_s": B * N / wall}


def _profile(label: str, fn):
    """Device busy time, idle share and the top kernels of one call of fn,
    from torch.profiler (the profiler's own overhead lengthens host time).
    Returns the number of device events (None when none were recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        # User annotations (e.g. "Optimizer.step#AdamW.step") also appear on
        # the device timeline; they span idle gaps and are not kernels.
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    if not spans:
        log(f"profile {label}: no device events recorded (device time not measured)")
        return None
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile {label}: device busy {busy / 1e3:.1f} ms of a {window / 1e3:.1f} ms window "
        f"(idle share {1 - busy / window:.3f}), {len(spans)} device events")
    for name, us in top:
        log(f"  {us / 1e3:8.2f} ms  {us / busy:6.1%}  {name[:100]}")
    return len(spans)


def phase_engine(cfg, params, launches: dict) -> None:
    import torch

    from ray_tpu_torch.kernels.flash_fwd import flash_fwd
    from ray_tpu_torch.kernels.rmsnorm import rmsnorm_fwd
    from ray_tpu_torch.serve.engine.engine import EngineOptions, InferenceEngine

    g = torch.Generator().manual_seed(11)

    def rand(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    shared = rand(256)
    prompts = [rand(n) for n in (64, 128, 192, 384, 448, 512)]
    first_shared = shared + rand(32)
    late_shared = shared + rand(96)      # arrives once the prefix is cached
    max_tokens = 32
    engine = InferenceEngine(
        cfg, params, EngineOptions(num_blocks=512, block_size=16, max_num_seqs=8), device="cuda")
    forwards = {"n": 0}  # paged forwards (prefill chunks, decode and verify steps)
    _finite_guard(engine, forwards)
    reset_launches()
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_tokens) for p in prompts + [first_shared]]
    steps = 0
    while not engine.scheduler.get(rids[-1]).output:
        engine.step()
        steps += 1
    rids.append(engine.submit(late_shared, max_tokens))
    steps += _drain(engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [list(engine.stream(r)) for r in rids]
    st = engine.stats()

    # Speculative decoding proposes a draft only when the history's last
    # token (spec_ngram=1) occurred before. Random weights give no such
    # repeats, so the prompt's FIRST token is set to the model's own first
    # output for that prompt (a fixed point, found by 1-token requests on
    # the same engine): the first decode step then drafts and verifies.
    spec = InferenceEngine(
        cfg, params, EngineOptions(num_blocks=64, block_size=16, max_num_seqs=4, spec_tokens=2,
                                   spec_ngram=1, enable_prefix_caching=False), device="cuda")
    _finite_guard(spec, forwards)
    spec_prompt = rand(128)
    for _ in range(8):
        probe = spec.submit(spec_prompt, 1)
        _drain(spec)
        first = list(spec.stream(probe))[0]
        if first == spec_prompt[0]:
            break
        spec_prompt[0] = first
    else:
        raise AssertionError("no prompt whose first output token it already holds")
    srid = spec.submit(spec_prompt, max_tokens)
    _drain(spec)
    spec_out = list(spec.stream(srid))
    sst = spec.stats()
    torch.cuda.synchronize()
    nf, nr, n_fwd = flash_fwd.launches, rmsnorm_fwd.launches, forwards["n"]
    launches["engine"] = read_launches()

    def engine_burst():
        for p in prompts[:4]:
            engine.submit(p[:64], 8)
        _drain(engine)
    _profile("engine llama-7b bf16, 4 requests x (64-token prompt + 8 tokens)", engine_burst)

    total = sum(len(o) for o in outs)
    log(f"engine llama-7b bf16: {len(outs)} requests, {steps} steps, {total} tokens in {wall:.2f} s "
        f"= {total / wall:.1f} tokens/s; TTFT p50 {st['ttft_p50_s'] * 1e3:.1f} ms, "
        f"TPOT p50 {st['tpot_p50_s'] * 1e3:.2f} ms; prefix-cache hits {st['prefix_cache_hits']} "
        f"blocks; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"engine spec_tokens=2: {len(spec_out)} tokens, drafts proposed {sst['spec_proposed']} "
        f"accepted {sst['spec_accepted']}; {n_fwd} paged forwards, launches flash={nf} "
        f"rmsnorm={nr}")
    if any(len(o) != max_tokens for o in outs) or len(spec_out) != max_tokens:
        raise AssertionError(f"unfinished requests: {[len(o) for o in outs]} / {len(spec_out)}")
    if st["prefix_cache_hits"] <= 0:
        raise AssertionError("no prefix-cache hit for the shared 256-token prefix")
    if sst["spec_proposed"] <= 0:
        raise AssertionError("speculative decoding never ran a verify step")
    L = cfg.n_layers
    # The paged paths attend in plain torch (as the reference does in plain
    # jnp); every norm of every paged forward runs the RMSNorm kernel.
    if nf != 0 or n_fwd <= 0 or nr != (2 * L + 1) * n_fwd:
        raise AssertionError(f"engine launch counts flash={nf} (want 0), rmsnorm={nr} "
                             f"(want {(2 * L + 1) * n_fwd} for {n_fwd} forwards)")


# ---------------------------------------------------------------- runtime
RUNTIME_BOOT_TIMEOUT_S = 300.0   # the GPU actor's boot: worker, CUDA, kernels, llama-7b
DAG_ROUND_TRIPS = 200


class LlamaGenerator:
    """The runtime phase's GPU actor: llama-7b bf16 at full width from the
    generate phase's seed, on the card its worker was given, with the
    kernel library the driver built (it must not build it again)."""

    def __init__(self):
        import torch

        from ray_tpu_torch.kernels import build

        self.prebuilt = (build.build_dir() / build.LIB_NAME).exists()
        build.library()
        self.cfg, self.params = _llama_params()
        self.info = {
            "pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device": torch.cuda.get_device_name(0),
            "prebuilt": self.prebuilt,
            "build_dir": str(build.build_dir()),
        }

    def ready(self) -> dict:
        return self.info

    def generate(self, prompt, n: int):
        """(tokens, wall s, launches per kernel) of make_generate on prompt."""
        toks, wall, counts = _timed_generate(self.cfg, self.params, prompt.to("cuda"), n)
        return toks.cpu(), wall, counts


class DecodeStep:
    """A compiled-DAG stage on the card: a decode step's message (B token
    ids, step counter) in, the ids moved through the card and the next
    step out."""

    def __init__(self):
        import torch

        self.device = torch.device("cuda")
        torch.zeros(1, device=self.device)  # the CUDA context, before the first round trip

    def step(self, msg):
        import torch

        ids, step = msg
        return (torch.from_numpy(ids).to(self.device) + 1).cpu().numpy(), step + 1


def _cpu_worker_probe() -> dict:
    """What a CPU task's worker sees (it runs in that worker)."""
    import torch

    from ray_tpu_torch.core import forkserver

    return {
        "pid": os.getpid(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "cuda_available": torch.cuda.is_available(),
        "template": dict(forkserver.TEMPLATE_REPORT),
        "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
        "reference": sorted(m for m in sys.modules if m == "ray_tpu" or m.startswith("ray_tpu.")),
    }


def _proc_stat(pid: int):
    """(parent pid, start time, state) of a live process, from /proc."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
    except OSError:
        return None
    fields = stat[stat.rindex(")") + 2:].split()
    return int(fields[1]), fields[19], fields[0]


def _descendants(root: int) -> dict:
    """{pid: start time} of `root` and its live descendants: with the
    runtime's controller as root, its forkserver template and workers."""
    stats = {int(p): _proc_stat(int(p)) for p in os.listdir("/proc") if p.isdigit()}
    children = {}
    for pid, st in stats.items():
        if st is not None:
            children.setdefault(st[0], []).append(pid)
    if stats.get(root) is None:
        return {}
    out, todo = {root: stats[root][1]}, [root]
    while todo:
        for child in children.get(todo.pop(), []):
            out[child] = stats[child][1]
            todo.append(child)
    return out


def _session_processes(known: dict, session_dir: str) -> list:
    """(pid, command) of this run's runtime processes that are still alive:
    those of `known` ({pid: start time}, taken before shutdown) that are
    still the same process, and any whose environment names the session's
    directory. Processes of other sessions on the machine are left alone."""
    out = []
    for p in os.listdir("/proc"):
        if not p.isdigit() or int(p) == os.getpid():
            continue
        pid, st = int(p), _proc_stat(int(p))
        if st is None or st[2] == "Z":
            continue
        ours = known.get(pid) == st[1]
        if not ours and session_dir:
            d = session_dir.encode()
            try:
                with open(f"/proc/{pid}/environ", "rb") as f:
                    ours = any(v.split(b"=", 1)[-1] in (d, d + b".sock") or
                               v.split(b"=", 1)[-1].startswith(d + b"/") for v in f.read().split(b"\0"))
            except OSError:
                continue
        if ours:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
            except OSError:
                continue
            out.append((pid, cmd))
    return out


def phase_runtime(generated: dict, launches: dict) -> None:
    """The port's runtime in cluster mode (processes): GPU detection, CPU
    workers without the card, a num_gpus=1 actor that must reproduce the
    generate phase's greedy tokens, put/get throughput, and one
    compiled-DAG channel through a GPU actor."""
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.kernels import build
    from ray_tpu_torch.models.gpt import llama_7b
    from ray_tpu_torch.util.accelerators import NvidiaGPUAcceleratorManager

    log(f"runtime: GPU detection without a CUDA context: {NvidiaGPUAcceleratorManager().get_current_node_num_accelerators()} "
        f"(CUDA_VISIBLE_DEVICES {os.environ.get('CUDA_VISIBLE_DEVICES', 'unset')}, "
        f"/proc/driver/nvidia/gpus {'present' if os.path.isdir('/proc/driver/nvidia/gpus') else 'absent'})")
    t0 = time.perf_counter()
    rt.init(log_to_driver=False)  # cluster mode: a controller, a template, workers
    backend = api._global_runtime().backend
    session_dir, controller = backend.session_dir, backend._controller_proc.pid
    try:
        res = rt.cluster_resources()
        log(f"runtime: cluster up in {time.perf_counter() - t0:.2f} s, resources {res}")
        if res.get("GPU") != 1.0:
            raise AssertionError(f"runtime: cluster_resources GPU {res.get('GPU')}, want 1.0")

        probes = rt.get([rt.remote(_cpu_worker_probe).remote() for _ in range(4)], timeout=120)
        for pr in probes:
            bad = []
            if pr["cuda_available"] or pr["cuda_visible_devices"] != "":
                bad.append(f"sees the card (CUDA_VISIBLE_DEVICES {pr['cuda_visible_devices']!r})")
            if pr["jax"] or pr["reference"]:
                bad.append(f"loaded {pr['jax'] + pr['reference']}")
            if not pr["template"]:
                bad.append("was not forked from the template")
            elif pr["template"]["cuda_initialized"] or not pr["template"]["torch"]:
                bad.append(f"template {pr['template']}")
            if bad:
                raise AssertionError(f"runtime: CPU worker {pr['pid']}: " + "; ".join(bad))
        log(f"runtime: {len(probes)} CPU tasks in {len({p['pid'] for p in probes})} forked workers: no card, "
            f"no jax, nothing of ray_tpu; template {probes[0]['template']}")

        B, S0, N = GENERATE_SHAPE
        t0 = time.perf_counter()
        actor = rt.remote(num_gpus=1)(LlamaGenerator).remote()
        info = rt.get(actor.ready.remote(), timeout=RUNTIME_BOOT_TIMEOUT_S)
        boot_s = time.perf_counter() - t0
        if not info["prebuilt"] or info["build_dir"] != str(build.build_dir()):
            raise AssertionError(f"runtime: the actor did not load the driver's kernel build: {info}")
        log(f"runtime: num_gpus=1 actor booted with llama-7b bf16 in {boot_s:.2f} s "
            f"(timeout {RUNTIME_BOOT_TIMEOUT_S:.0f} s; pid {info['pid']}, CUDA_VISIBLE_DEVICES "
            f"{info['cuda_visible_devices']!r}, {info['device']}, kernels from {info['build_dir']})")
        toks, wall, counts = rt.get(actor.generate.remote(generated["prompt"], N), timeout=600)
        launches["runtime"] = counts
        _check_generate(llama_7b(), toks, counts, "runtime actor")
        want = generated["tokens"]
        if not torch.equal(toks, want):
            b, i = (int(x) for x in (toks != want).nonzero()[0])
            raise AssertionError(f"runtime: the actor's tokens differ from the generate phase's first at "
                                 f"batch {b} position {i}: {int(toks[b, i])} vs {int(want[b, i])}")
        log(f"runtime: actor generate B={B} prompt={S0} new={N}: {B * N / wall:.1f} tokens/s in the actor "
            f"against {generated['tokens_per_s']:.1f} in process; tokens equal the generate phase's; "
            f"launches {counts}")

        x = torch.randn(64 << 20)  # 256 MiB of f32
        nbytes = x.numel() * x.element_size()
        t0 = time.perf_counter()
        ref = rt.put(x)
        t1 = time.perf_counter()
        y = rt.get(ref)
        t2 = time.perf_counter()
        if not torch.equal(x, y):
            raise AssertionError("runtime: get(put(x)) != x")
        log(f"runtime: put 256 MiB CPU tensor {nbytes / (t1 - t0) / 1e9:.3f} GB/s, get "
            f"{nbytes / (t2 - t1) / 1e9:.3f} GB/s")
        del x, y, ref

        rt.kill(actor)  # frees the GPU resource (and its 13.5 GB) for the DAG's actor
        del actor
        with InputNode() as inp:
            dag = rt.remote(num_gpus=1)(DecodeStep).bind().step.bind(inp)
        compiled = dag.experimental_compile()
        try:
            lat = []
            for i in range(DAG_ROUND_TRIPS + 10):
                ids = np.arange(B, dtype=np.int64) + 1000 * i
                t0 = time.perf_counter()
                out_ids, step = compiled.execute((ids, i)).get(timeout=120)
                if i >= 10:  # the first round trips warm the channels
                    lat.append(time.perf_counter() - t0)
                if step != i + 1 or not np.array_equal(out_ids, ids + 1):
                    raise AssertionError(f"runtime: DAG round trip {i} returned {out_ids}, {step}")
        finally:
            compiled.teardown()
        lat.sort()
        log(f"runtime: compiled-DAG round trip driver -> GPU actor -> driver (B={B} ids + step): "
            f"p50 {lat[len(lat) // 2] * 1e6:.1f} us, p90 {lat[int(len(lat) * 0.9)] * 1e6:.1f} us over "
            f"{len(lat)}")
    finally:
        known = _descendants(controller)
        rt.shutdown()
        deadline = time.monotonic() + 30
        while _session_processes(known, session_dir) and time.monotonic() < deadline:
            time.sleep(0.5)
        left = [(pid, f"parent {(_proc_stat(pid) or ('gone',))[0]}", cmd)
                for pid, cmd in _session_processes(known, session_dir)]
        for pid, _, _ in left:
            try:
                os.kill(pid, 9)
            except OSError:
                pass
    if left:
        raise AssertionError(f"runtime: processes outlived shutdown (killed): {left}")


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import ray_tpu_torch  # noqa: F401 — fails here when run outside the repository
    from ray_tpu_torch.kernels import build

    t_start = time.perf_counter()
    CARD = card_line()
    print(CARD, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: "
        f"{torch.cuda.get_device_name(0)}; {torch.cuda.device_count()} visible")

    if "build" in phases or "kernels" in phases:
        build.library()
        log(f"build: {build.build_seconds:.1f} s into {build.build_dir()}")
        check_build(build)

    results: dict = {}
    if "kernels" in phases:
        phase_kernels(results)
    if "parity" in phases:
        phase_parity()
    launches: dict = {}  # path -> kernel -> launches in that path's run
    if "train_parity" in phases:
        phase_train_parity(launches)
    if "train" in phases:
        phase_train(launches)
    generated = None
    if "generate" in phases or "engine" in phases:
        cfg, params = _llama_params()
        if "generate" in phases:
            generated = phase_generate(cfg, params, launches)
        if "engine" in phases:
            phase_engine(cfg, params, launches)
        del params  # the runtime phase's actor loads its own copy
        torch.cuda.empty_cache()
    if "runtime" in phases:
        if generated is None:
            ap.error("the runtime phase holds its actor's tokens against the generate phase's: run both")
        log(f"driver device memory before the runtime phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            "allocated")
        phase_runtime(generated, launches)
    log(f"wall time {time.perf_counter() - t_start:.1f} s")

    if phases != list(PHASES):
        return 0
    for name, r in results.items():
        r["launches_by_path"] = {path: n[name] for path, n in launches.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if r["launches"] <= 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    # The backward rows: the pair (dQ with Delta, dK/dV) against the library's backward
    # (profiler device time; its eager loop beside it).
    # flash_fwd: the forward with lse at the training shape, at the generate
    # path's prefill shape, and at a long (S=2048) prompt.
    extra = ("pair_ms", "pair_profiled_ms", "library_eager_ms", "train_shape", "train_shape_ms", "train_shape_bound_ms", "train_shape_bound_by",
             "train_shape_plain_ms", "train_shape_library_ms", "generate_shape_ms",
             "generate_shape_library_ms", "long_shape_ms", "long_shape_library_ms",
             # rmsnorm: every timed row (kernel, F.rms_norm, bound), the launch floor, a
             # plain copy of the record shape's bytes
             "shapes", "launch_floor_ms", "copy_ms")
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys}, **{k: r[k] for k in extra if k in r}}
                                  for r in results.values()]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

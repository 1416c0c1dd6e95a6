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
              kernels pad (80 -> 128), at one above 256 (288 -> 320, the
              wide-head route) and at a sequence split over several
              launches of each kernel (S=32769, D=128); the wide-head route
              of the three flash kernels timed at B=1 H=8 S=1024 D=512
  4. parity   llama-7b widths, 2 layers, f32: make_generate and
              InferenceEngine on the card vs make_generate on the CPU
  5. train_parity  llama-7b widths, 2 layers, f32, remat "attn": loss and
              every gradient on the card vs the CPU, then the params after
              3 AdamW steps
  6. train    bench.py's step: gpt2-large, B=13 x S=1024, bf16 compute, f32
              master weights, remat "attn", AdamW(3e-4, wd 0.1, bf16 mu):
              tokens/s, step ms, MFU, peak memory, launches per step
  6b. trainer training on the copied runtime: ray_tpu_torch.init() in
              cluster mode, TorchTrainer gangs of one GPU worker over a
              one-rank NCCL world (torch_utils.get_mesh()): the train
              phase's step through the trainer, its losses and grad norms
              bit-equal to an in-process plain run (tokens/s beside it);
              the GPipe step at llama-7b widths (4 layers, B=8 x S=512,
              M=4) on the pp=1 mesh, its first loss within 2e-3 of loss_fn
              and its launches as predicted from M and the layers; the
              pipeline at llama-7b widths (2 layers, f32) card vs CPU in
              the driver; and gpt2-large at 4 layers, B=4 x S=1024, 10
              steps with an elastic checkpoint every 2, its worker
              SIGKILLed after step 5: the gang restarts on a new worker
              from the step-4 commit and every loss equals the unkilled
              run's bit for bit (restart s, checkpoint MB, step ms with and
              without a save in flight)
  6c. mpmd    MPMD pipeline training on the copied runtime: MPMDTrainer gangs
              of GPU-worker stage actors (num_gpus 1/(S*dp) each), 1F1B over
              compiled-DAG edges with ZeRO updates: llama-7b widths (4
              layers, B=8 x S=512, M=4, 2 stages, dp=1; the trainer phase's
              GPipe cell), its first loss within 2e-3 of loss_fn, falling,
              launches per step as predicted (step ms, tokens/s, busy and
              update s per stage, the bubble, edge bytes); the same run
              interleaved (v=2) with the v=1 losses; run_local_pipeline
              card vs CPU (llama-7b widths, 2 layers, f32); gpt2-large
              widths (4 layers, tied: the bridge runs) at dp=2, ZeRO, a
              checkpoint every 2 steps, a stage-1 replica SIGKILLed after
              step 3: the gang re-spawns, restores at the common commit and
              repeats an unkilled replicated run's losses bit for bit; ZeRO
              halves the optimizer bytes per replica (restart s, update s,
              bridge bytes)
  6d. parallel the mesh path on a one-rank NCCL world (make_mesh(), all six
              axes 1): gpt2-medium-moe (8 experts, top-2) training at full
              width through make_train_step(mesh=) (tokens/s, step ms,
              device busy, peak memory, flash launches); the MoE model at 2
              layers in f32, card vs CPU (loss and every gradient); the
              train phase's gpt2-large step through the mesh against the
              plain step (first loss, tokens/s); llama-7b widths at 2 layers,
              bf16: Ulysses equal to the flash forward, ring within bf16
  7. generate full llama-7b, bf16, seeded random weights: make_generate
  8. engine   full llama-7b, bf16: the continuous-batching engine with
              prefix caching, chunked prefill and speculative decoding
  9. runtime  the port's runtime in cluster mode on this machine: the GPU
              detected, CPU workers forked from a template that sees no card,
              an actor with num_gpus=1 that builds llama-7b bf16 (seed 0) and
              generates the generate phase's tokens, put/get of 256 MiB, a
              compiled-DAG round trip through a GPU actor
 10. serve    llama-7b behind LLMDeployment on the port's Serve (cluster
              mode, HTTP proxy): one num_gpus=1 replica returns the engine
              phase's lone-request tokens exactly (handle and HTTP) and
              serves its 8 requests as a streamed burst; a prefill and a
              decode replica (num_gpus=0.5 each) return colocated tokens
              exactly at the parity model (f32, 2 layers) and import every
              full block at full width (bf16); the card's memory is
              released after shutdown

Prints progress lines, one `{"kernels": [...]}` line, the card line, and
last `{"ok": true, "device": {...}}`. Exits non-zero on any failure and
without a CUDA card. `--phases` runs a subset (no final ok line then).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PHASES = ("device", "build", "kernels", "parity", "train_parity", "train", "trainer", "mpmd", "parallel",
          "generate", "engine", "runtime", "serve")
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


@contextlib.contextmanager
def counted(total: dict):
    """One run of a path: the counts are set to 0 just before the block and
    read just after it into the dict it yields, which is added to `total`
    (the path's launches over all of its runs)."""
    reset_launches()
    run: dict = {}
    yield run
    run.update(read_launches())
    for name, n in run.items():
        total[name] = total.get(name, 0) + n


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
    _time_flash_wide(results, randn)
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
    the next), one above 256 (padded to 320, the wide-head route), and a
    sequence past every tile table (each kernel split into
    several launches; the plain side holds several 4 GB f32 matrices)."""
    import torch

    from ray_tpu_torch.kernels.flash_bwd import flash_bwd_dkv, flash_bwd_dq
    from ray_tpu_torch.kernels.flash_fwd import flash_fwd
    from ray_tpu_torch.ops.attention import (flash_attention_bwd_plain, flash_attention_plain,
                                             flash_attention_with_stats)

    for tag, (B, H, S, D), want in (("padded D=80", (2, 3, 200, 80), (1, 1, 1)),
                                    ("wide D=288", (2, 3, 200, 288), (1, 1, 1)),
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


# The wide-head route's timed shape (no configuration of the repository has
# a head dim above 256): bf16, causal.
WIDE_ATTN = (1, 8, 1024, 512)


def _time_flash_wide(results: dict, randn) -> None:
    """The wide-head route (D > 256) of the three flash kernels at WIDE_ATTN:
    forward with lse, dQ with Delta and dK/dV, each against its plain version
    and timed beside its bound, the plain version and the library call; a
    `wide` entry under each of the three kernels' rows."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.kernels.flash_bwd import flash_bwd_dkv, flash_bwd_dq
    from ray_tpu_torch.kernels.flash_fwd import flash_fwd
    from ray_tpu_torch.ops.attention import flash_attention_bwd_plain, flash_attention_plain

    B, H, S, D = WIDE_ATTN
    scale = D ** -0.5
    shape = f"B={B} H={H} S={S} D={D} bf16 causal"
    q, k, v, do = (randn(B, H, S, D, dtype=torch.bfloat16) for _ in range(4))
    before = read_launches()
    o, lse = flash_fwd(q, k, v, True, scale, True)
    ref, ref_lse = flash_attention_plain(q, k, v, True, scale, return_lse=True)
    fwd_err = max(compare(f"flash wide {shape} out", o, ref, TOL["bf16"]),
                  compare(f"flash wide {shape} lse", lse.reshape(ref_lse.shape), ref_lse, TOL["bf16"]))
    del ref, ref_lse
    errs = _check_bwd_case(f"wide {shape}", q, k, v, do, True, TOL["bf16"])
    n = {k_: v_ - before[k_] for k_, v_ in read_launches().items()}
    if (n["flash_fwd"], n["flash_bwd_dq"], n["flash_bwd_dkv"]) != (2, 1, 1):  # the check's own forward too
        raise AssertionError(f"flash wide: launches {n}, want one per call")
    delta = flash_bwd_dq(q, k, v, o, do, lse, True, scale)[1]
    pairs = B * H * S * (S + 1) // 2
    tile = B * H * S * D * 2
    rows = B * H * S * 4
    library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
    try:
        library()
    except RuntimeError as e:  # a yardstick only: the port never calls it
        log(f"flash wide: scaled_dot_product_attention refuses {shape}: {e}")
        library = None
    library_ms = cuda_ms(library)[0] if library is not None else None
    library_bwd_ms = None
    if library is not None:
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        library_bwd_ms = profiled_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True))
    bwd_plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, True, scale), iters=3)[0]
    for name, fn, flops, nbytes, err, plain_ms, lib_ms in (
        ("flash_fwd", lambda: flash_fwd(q, k, v, True, scale, True), 4 * D * pairs, 4 * tile + rows, fwd_err,
         cuda_ms(lambda: flash_attention_plain(q, k, v, True, scale, return_lse=True), iters=3)[0], library_ms),
        ("flash_bwd_dq", lambda: flash_bwd_dq(q, k, v, o, do, lse, True, scale), 6 * D * pairs,
         6 * tile + 2 * rows, max(errs[:2]), bwd_plain_ms, library_bwd_ms),
        ("flash_bwd_dkv", lambda: flash_bwd_dkv(q, k, v, do, lse, delta, True, scale), 8 * D * pairs,
         6 * tile + 2 * rows, max(errs[2:]), bwd_plain_ms, library_bwd_ms),
    ):
        ops_s, bytes_s = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
        ms, eager_ms = cuda_ms(fn, iters=5)
        results[name]["wide"] = dict(
            route="cuda", source="ray_tpu_torch/kernels/csrc/flash_wide.cu", shape=shape, ms=ms,
            eager_ms=eager_ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
            bound_ms=max(ops_s, bytes_s) * 1e3, bound_by="operations" if ops_s >= bytes_s else "bytes")
        w = results[name]["wide"]
        lib = "null" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"{name} wide-head route at {shape}: kernel {ms:.4f} ms, bound {w['bound_ms']:.4f} ms "
            f"({w['bound_by']}), plain {plain_ms:.4f} ms, library {lib}")
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()


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


# ------------------------------------------------------------------ trainer
TRAINER_ADAMW = dict(lr=3e-4, weight_decay=0.1)  # bench.py's, with mu in bf16


@dataclasses.dataclass
class TrainerSpec:
    """What the trainer phase trains. Each job is (model, overrides, (B, S))
    with its step counts: `step` is bench.py's gpt2-large step through the
    trainer, `pipe` the GPipe step at llama-7b widths (depth cut) on the
    gang's pp=1 mesh, `parity` the pipeline's card-vs-CPU check in the
    driver, `kill` the run whose worker is SIGKILLed. `device` None: the
    card; the CPU rehearsal (tests/test_torch_chip_smoke.py) passes tiny
    models on "cpu" and one torch thread (`threads`), so that the driver's
    and the worker's CPU products agree bit for bit."""

    step: tuple = ("gpt2-large", {}, (13, 1024))
    warm: int = 2
    timed: int = 5
    pipe: tuple = ("llama-7b", {"n_layers": 4}, (8, 512))
    pipe_micro: int = 4
    pipe_steps: int = 6              # 2 + 4
    parity: tuple = ("llama-7b", {"n_layers": 2, "dtype": "float32"}, (2, 128))
    parity_micro: int = 2
    kill: tuple = ("gpt2-large", {"n_layers": 4}, (4, 1024))
    kill_steps: int = 10
    save_every: int = 2
    kill_after: int = 5
    init: dict = dataclasses.field(default_factory=lambda: {"log_to_driver": False})
    device: str | None = None
    threads: int | None = None


def _trainer_cfg(job: tuple):
    """The GPTConfig of a (model, overrides, (B, S)) job: flash attention,
    remat "attn", bf16 compute unless overridden, max_seq at least S."""
    from ray_tpu_torch.models.gpt import CONFIGS

    model, over, (_, S) = job
    return CONFIGS[model](**{"attn_impl": "flash", "remat": True, "remat_policy": "attn",
                             "max_seq": max(CONFIGS[model]().max_seq, S), **over})


def _trainer_batch(cfg, shape, seed: int, device):
    """{"tokens": [B, S+1]} drawn from a generator keyed by `seed` (a step
    of the killed run: its resumed incarnation draws the same batches)."""
    import torch

    B, S = shape
    dev = torch.device(device)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1), device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(seed))}


def _trainer_loop():
    """The TorchTrainer's train_loop_per_worker (a closure, so cloudpickle
    ships it by value: the worker imports only ray_tpu_torch). Every step
    reports its loss and the kernel launches it made, counted in the
    worker: the counts are set to 0 just before each step and read just
    after it."""

    def loop(config):
        import os
        import time

        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.kernels.flash_bwd import flash_bwd_dkv, flash_bwd_dq
        from ray_tpu_torch.kernels.flash_fwd import flash_fwd
        from ray_tpu_torch.kernels.rmsnorm import rmsnorm_fwd
        from ray_tpu_torch.models import gpt
        from ray_tpu_torch.optim import AdamW
        from ray_tpu_torch.parallel import place
        from ray_tpu_torch.parallel.mesh import axis_size
        from ray_tpu_torch.train import torch as tt
        from ray_tpu_torch.train.session import get_session

        t_loop = time.time()
        if config["threads"]:
            torch.set_num_threads(config["threads"])
        kernels = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv,
                   "rmsnorm": rmsnorm_fwd}
        mesh = tt.torch_utils.get_mesh(device_type=config["device_type"])
        dev = tt.get_device()
        on_card = dev.type == "cuda"
        info = {"pid": os.getpid(), "t_loop": t_loop, "backend": dist.get_backend(), "device": str(dev),
                "device_name": torch.cuda.get_device_name(dev) if on_card else "cpu",
                "mesh": {n: int(s) for n, s in zip(mesh.mesh_dim_names, mesh.mesh.shape)},
                "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}

        def sync():
            if on_card:
                torch.cuda.synchronize()

        def counted(fn):
            for k in kernels.values():
                k.launches = 0
            out = fn()
            return out, {n: k.launches for n, k in kernels.items()}

        def placed(params, shardings):
            return {k: place(v, mesh, shardings[k]).detach() for k, v in params.items()}

        def report(job, **m):
            train.report({"job": job, "t": time.time(), **info, **m})

        def adamw(params):
            return AdamW(params.values(), **config["adamw"], mu_dtype=torch.bfloat16)

        def draw(cfg, B, S, seed):  # _trainer_batch's draw
            return {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1), device=dev,
                                            generator=torch.Generator(device=dev).manual_seed(seed))}

        if config["job"] == "step":
            # bench.py's step through the mesh, then the GPipe step.
            cfg, (B, S) = config["step"]
            params = placed(gpt.init_params(cfg, seed=0, device=dev), gpt.param_shardings(cfg, mesh))
            step = gpt.make_train_step(cfg, adamw(params), mesh=mesh)
            batch = draw(cfg, B, S, 1)
            t0 = None
            for i in range(config["warm"] + config["timed"]):
                if i == config["warm"]:
                    sync()
                    t0 = time.perf_counter()
                (_, m), launches = counted(lambda: step(params, batch))
                report("step", i=i, loss=m["loss"].item(), grad_norm=m["grad_norm"].item(), launches=launches)
            sync()
            report("step_summary", tokens_per_s=B * S * config["timed"] / (time.perf_counter() - t0))
            del params, step
            if on_card:
                torch.cuda.empty_cache()

            cfg, (B, S) = config["pipe"]
            M, pp = config["pipe_micro"], axis_size(mesh, "pp")
            params = gpt.init_params(cfg, seed=2, device=dev)
            batch = draw(cfg, B, S, 3)
            with torch.no_grad():
                serial = gpt.loss_fn(params, batch, cfg).item()
            staged = placed(gpt.split_stage_params(params, cfg, pp), gpt.pipeline_stage_shardings(cfg, mesh))
            del params
            step = gpt.make_pipeline_train_step(cfg, adamw(staged), mesh, M)
            for i in range(config["pipe_steps"]):
                (_, m), launches = counted(lambda: step(staged, batch))
                report("pipe", i=i, loss=m["loss"].item(), grad_norm=m["grad_norm"].item(), serial=serial,
                       launches=launches)
            del staged, step
            if on_card:
                torch.cuda.empty_cache()
            return

        # The killed run: an elastic checkpoint every `save_every` steps;
        # the first incarnation waits to be killed after step `kill_after`.
        cfg, (B, S) = config["kill"]
        params = placed(gpt.init_params(cfg, seed=4, device=dev), gpt.param_shardings(cfg, mesh))
        opt = adamw(params)
        step = gpt.make_train_step(cfg, opt, mesh=mesh)
        sess = train.get_elastic_session()
        t0 = time.perf_counter()
        tree = sess.restore()
        restored = None
        if tree is not None:
            restored = sess.state.step
            with torch.no_grad():
                for k, p in params.items():
                    mu = torch.zeros_like(p, dtype=torch.bfloat16)
                    nu = torch.zeros_like(p)
                    for dst, src in ((p, tree["params"][k]), (mu, tree["mu"][k]), (nu, tree["nu"][k])):
                        (dst.to_local() if hasattr(dst, "to_local") else dst).copy_(src)
                    opt.state[p] = {"step": tree["t"], "mu": mu, "nu": nu}
            del tree
        restore_s = time.perf_counter() - t0
        for s in range(sess.state.step, config["kill_steps"]):
            in_flight = sess.writer._pending > 0
            batch = draw(cfg, B, S, 100 + s)
            t0 = time.perf_counter()
            (_, m), launches = counted(lambda: step(params, batch))
            loss = m["loss"].item()
            ms = (time.perf_counter() - t0) * 1e3
            report("kill", step=s + 1, loss=loss, ms=ms, save_in_flight=in_flight, launches=launches,
                   restored_from=restored, restore_s=restore_s)
            if (s + 1) % config["save_every"] == 0:
                t0 = time.perf_counter()
                sess.save(s + 1, {"params": params, "mu": {k: opt.state[p]["mu"] for k, p in params.items()},
                                  "nu": {k: opt.state[p]["nu"] for k, p in params.items()},
                                  "t": opt.state[next(iter(params.values()))]["step"]})
                report("save", step=s + 1, block_ms=(time.perf_counter() - t0) * 1e3)
            if s + 1 == config["kill_after"] and not os.path.exists(config["marker"]):
                sess.flush()  # the last commit before the kill has landed
                session = get_session()
                while session.history:  # every report polled and acknowledged by the driver
                    time.sleep(0.01)
                with open(config["marker"] + ".tmp", "w") as f:
                    f.write(str(os.getpid()))
                os.rename(config["marker"] + ".tmp", config["marker"])
                time.sleep(600)
                raise RuntimeError("the worker was not killed")
        sess.flush()

    return loop


def _trainer_in_process(job: tuple, steps: int, device, seeds, warm: int = 0):
    """The plain step (no mesh) in the driver from the trainer's seeds:
    (losses, grad norms, tokens/s over the steps after `warm`). `seeds`:
    (params seed, batch seed or None for one batch per step keyed 100 + s)."""
    import torch

    from ray_tpu_torch.models.gpt import init_params, make_train_step
    from ray_tpu_torch.optim import AdamW

    cfg = _trainer_cfg(job)
    params = init_params(cfg, seed=seeds[0], device=device)
    step = make_train_step(cfg, AdamW(params.values(), **TRAINER_ADAMW, mu_dtype=torch.bfloat16))
    batches = [_trainer_batch(cfg, job[2], seeds[1] if seeds[1] is not None else 100 + s, device)
               for s in range(steps)]
    losses, norms, t0 = [], [], None
    for s, batch in enumerate(batches):
        if s == warm:
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
        _, m = step(params, batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    if device != "cpu":
        torch.cuda.synchronize()
    tok_s = job[2][0] * job[2][1] * (steps - warm) / (time.perf_counter() - t0)
    del params, step
    if device != "cpu":
        torch.cuda.empty_cache()
    return losses, norms, tok_s


def _pipeline_parity(spec: TrainerSpec, counts: dict) -> None:
    """The GPipe loss and every gradient on a pp=1 mesh, f32, TF32 off: the
    card (kernels) against the port's CPU path, in the driver."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import make_mesh, place

    on_card = spec.device is None
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    _one_rank_world("cpu:gloo,cuda:nccl" if on_card else "gloo")
    try:
        cfg = _trainer_cfg(spec.parity)
        cpu_mesh, dev_mesh = make_mesh("cpu"), make_mesh("cuda" if on_card else "cpu")
        params = gpt.split_stage_params(gpt.init_params(cfg, seed=1, device="cpu"), cfg, 1)
        batch = _trainer_batch(cfg, spec.parity[2], 5, "cpu")
        M = spec.parity_micro
        out = {}
        for name, mesh in (("cpu", cpu_mesh), ("card", dev_mesh)):
            dev = "cuda" if name == "card" and on_card else "cpu"
            shardings = gpt.pipeline_stage_shardings(cfg, mesh)
            p = {k: place(v.to(dev), mesh, shardings[k]).detach().requires_grad_(True) for k, v in params.items()}
            t0 = time.perf_counter()
            with counted(counts) if name == "card" else contextlib.nullcontext({}) as run:
                loss = gpt.pipeline_loss_fn(p, {"tokens": batch["tokens"].to(dev)}, cfg, mesh, M)
                loss.backward()
            out[name] = (loss.full_tensor().item(), {k: v.grad.full_tensor().cpu() for k, v in p.items()
                                                      if v.grad is not None}, time.perf_counter() - t0)
        (lc, gc, tc), (lg, gg, _) = out["cpu"], out["card"]
        loss_d = abs(lg - lc) / abs(lc)
        errs = {k: (gg[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30) for k, g in gc.items()}
        worst = max(errs, key=errs.get)
        log(f"trainer pipeline parity f32 {spec.parity[0]} {spec.parity[1]} B,S={spec.parity[2]} M={M} pp=1, "
            f"card vs CPU: loss {lg:.6f} vs {lc:.6f} (rel diff {loss_d:.2e}); grads max|d|/max|ref|: worst "
            f"{errs[worst]:.2e} ({worst}); CPU {tc:.1f} s; launches on the card {run}")
        if set(gg) != set(gc) or loss_d > 1e-5 or errs[worst] > 1e-4:
            raise AssertionError(f"trainer pipeline parity: loss rel diff {loss_d:.2e} (tol 1e-5), grad {worst} "
                                 f"{errs[worst]:.2e} (tol 1e-4), gradients of {sorted(set(gg) ^ set(gc))} on "
                                 "one side only")
        L = cfg.n_layers
        want = {"flash_fwd": M * L, "flash_bwd_dq": M * L, "flash_bwd_dkv": M * L, "rmsnorm": 4 * M * L + 1}
        if on_card and run != want:
            raise AssertionError(f"trainer pipeline parity: launches {run}, want {want}")
    finally:
        dist.destroy_process_group()
    if on_card:
        torch.cuda.empty_cache()


def _fit(loop, config: dict, storage: str, name: str):
    from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig, TorchTrainer

    return TorchTrainer(loop, train_loop_config=config,
                        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                        run_config=RunConfig(storage_path=storage, name=name,
                                             failure_config=FailureConfig(max_failures=1))).fit()


def _sum_launches(total: dict, reports) -> None:
    for r in reports:
        for k, n in r.get("launches", {}).items():
            total[k] = total.get(k, 0) + n


def _check_equal(what: str, got: list, want: list) -> None:
    """Bit for bit: the trainer's values against the in-process run's."""
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad or len(got) != len(want):
        raise AssertionError(f"trainer: {what} differ from the in-process run's (step, got, want): {bad[:4]}; "
                             f"{len(got)} vs {len(want)} values")


def phase_trainer(launches: dict, spec: TrainerSpec | None = None) -> dict:
    """Train on the copied runtime: `ray_tpu_torch.init()` in cluster mode,
    then `TorchTrainer` gangs of one GPU worker over a one-rank NCCL world
    (`torch_utils.get_mesh()`): bench.py's gpt2-large step, bit-equal to the
    driver's plain step from the same seeds; the GPipe step at llama-7b
    widths (depth cut) on the pp=1 mesh, its first loss within 2e-3 of the
    serial loss; the pipeline's parity in the driver (card vs CPU); and a
    run whose worker is SIGKILLed after step `kill_after`, which restarts
    on a new worker from its last elastic checkpoint and repeats the
    unkilled run's losses bit for bit. Returns the GPipe step's timing
    ({"step_ms", "tokens_per_s"}: report to report, after the warm-up)."""
    import tempfile
    import threading

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api

    spec = spec or TrainerSpec()
    on_card = spec.device is None
    device = "cuda" if on_card else spec.device
    counts: dict = {}  # the launches of the phase's runs on the main path
    if spec.threads:
        torch.set_num_threads(spec.threads)

    # 1. The driver's own runs first, each freed before the next: the plain
    # step (bench.py's) and the unkilled run, then the pipeline's parity.
    want_step, want_norms, in_process_tok_s = _trainer_in_process(spec.step, spec.warm + spec.timed, device,
                                                                  (0, 1), warm=spec.warm)
    want_kill, _, _ = _trainer_in_process(spec.kill, spec.kill_steps, device, (4, None))
    _pipeline_parity(spec, counts)

    jobs = {name: (_trainer_cfg(job), job[2]) for name, job in (("step", spec.step), ("pipe", spec.pipe),
                                                                  ("kill", spec.kill))}
    storage = tempfile.mkdtemp(prefix="rtput-trainer-")
    base = {"device_type": device, "threads": spec.threads, "adamw": TRAINER_ADAMW, **jobs,
            "warm": spec.warm, "timed": spec.timed, "pipe_micro": spec.pipe_micro, "pipe_steps": spec.pipe_steps,
            "kill_steps": spec.kill_steps, "save_every": spec.save_every, "kill_after": spec.kill_after,
            "marker": os.path.join(storage, "kill.pid")}
    t0 = time.perf_counter()
    rt.init(**spec.init)
    backend = api._global_runtime().backend
    session_dir, controller = backend.session_dir, backend._controller_proc.pid
    try:
        log(f"trainer: cluster up in {time.perf_counter() - t0:.2f} s, resources {rt.cluster_resources()}")

        # 2. bench.py's step and the GPipe step through the trainer.
        t_fit = time.time()
        result = _fit(_trainer_loop(), {**base, "job": "step"}, storage, "step")
        if result.error:
            raise AssertionError(f"trainer: the step run failed: {result.error}")
        hist = result.metrics_history
        steps = [m for m in hist if m["job"] == "step"]
        pipe = [m for m in hist if m["job"] == "pipe"]
        summary = next(m for m in hist if m["job"] == "step_summary")
        first = hist[0]
        _sum_launches(counts, steps + pipe)
        log(f"trainer: worker pid {first['pid']} on {first['device_name']} ({first['device']}, "
            f"CUDA_VISIBLE_DEVICES {first['cuda_visible_devices']!r}), backend {first['backend']}, mesh "
            f"{first['mesh']}; worker boot {first['t_loop'] - t_fit:.2f} s, fit() to the first report "
            f"{first['t'] - t_fit:.2f} s")
        _check_equal("losses", [m["loss"] for m in steps], want_step)
        _check_equal("grad norms", [m["grad_norm"] for m in steps], want_norms)
        B, S = spec.step[2]
        log(f"trainer step {spec.step[0]} B={B} S={S}: losses and grad norms of {len(steps)} steps equal the "
            f"in-process plain step's bit for bit ({want_step[0]:.6f} -> {want_step[-1]:.6f}); "
            f"{summary['tokens_per_s']:.1f} tokens/s through the trainer, {in_process_tok_s:.1f} in process "
            f"({summary['tokens_per_s'] / in_process_tok_s:.3f}x); launches per step {steps[-1]['launches']}")
        pcfg = _trainer_cfg(spec.pipe)
        M, L = spec.pipe_micro, pcfg.n_layers
        rel = abs(pipe[0]["loss"] - pipe[0]["serial"]) / abs(pipe[0]["serial"])
        log(f"trainer pipeline {spec.pipe[0]} {spec.pipe[1]} B,S={spec.pipe[2]} M={M} pp=1: loss "
            f"{pipe[0]['loss']:.6f} -> {pipe[-1]['loss']:.6f} over {len(pipe)} steps, serial loss_fn "
            f"{pipe[0]['serial']:.6f} (rel diff {rel:.2e}); launches per step {pipe[-1]['launches']}")
        gaps = [b["t"] - a["t"] for a, b in zip(pipe, pipe[1:])][max(spec.warm - 1, 0):]
        gpipe = {"step_ms": sum(gaps) / len(gaps) * 1e3,
                 "tokens_per_s": spec.pipe[2][0] * spec.pipe[2][1] * len(gaps) / sum(gaps)}
        log(f"trainer pipeline step {gpipe['step_ms']:.1f} ms, {gpipe['tokens_per_s']:.1f} tokens/s (report to "
            f"report, {len(gaps)} steps after {spec.warm} warm-up)")
        if rel > 2e-3 or not (math.isfinite(pipe[-1]["loss"]) and pipe[-1]["loss"] < pipe[0]["loss"]):
            raise AssertionError(f"trainer pipeline: first loss {rel:.2e} from the serial loss (tol 2e-3), or the "
                                 f"loss {pipe[0]['loss']} -> {pipe[-1]['loss']} is not finite and falling")
        if on_card:
            Ls = _trainer_cfg(spec.step).n_layers
            for what, reports, want in (
                    ("step", steps, {"flash_fwd": Ls, "flash_bwd_dq": Ls, "flash_bwd_dkv": Ls, "rmsnorm": 0}),
                    ("pipeline", pipe, {"flash_fwd": M * L, "flash_bwd_dq": M * L, "flash_bwd_dkv": M * L,
                                        "rmsnorm": 4 * M * L + 1})):
                bad = [m["launches"] for m in reports if m["launches"] != want]
                if bad:
                    raise AssertionError(f"trainer {what}: launches per step {bad[0]}, predicted {want}")

        # 3. The killed run: SIGKILL the worker after step kill_after.
        known = _descendants(controller)
        killed: dict = {}
        done = threading.Event()

        def killer():
            while not os.path.exists(base["marker"]):
                if done.wait(0.01):
                    return
            pid = int(open(base["marker"]).read())
            ours = {p for p, _ in _session_processes({**known, **_descendants(controller)}, session_dir)}
            if pid not in ours:
                killed["error"] = f"pid {pid} is not a process of this session"
                return
            os.kill(pid, 9)
            killed["t"], killed["pid"] = time.time(), pid

        th = threading.Thread(target=killer, daemon=True)
        th.start()
        try:
            result = _fit(_trainer_loop(), {**base, "job": "kill"}, storage, "kill")
        finally:
            done.set()
            th.join(timeout=5)
        if result.error or "t" not in killed:
            raise AssertionError(f"trainer: the killed run failed ({result.error}) or its worker was not killed "
                                 f"({killed})")
        runs = [m for m in result.metrics_history if m["job"] == "kill"]
        saves = [m for m in result.metrics_history if m["job"] == "save"]
        _sum_launches(counts, runs)
        before = [m for m in runs if m["pid"] == killed["pid"]]
        after = [m for m in runs if m["pid"] != killed["pid"]]
        last_commit = (spec.kill_after // spec.save_every) * spec.save_every
        if [m["step"] for m in before] != list(range(1, spec.kill_after + 1)) or \
                [m["step"] for m in after] != list(range(last_commit + 1, spec.kill_steps + 1)) or \
                after[0]["restored_from"] != last_commit:
            raise AssertionError(f"trainer: steps before the kill {[m['step'] for m in before]}, after "
                                 f"{[m['step'] for m in after]} (restored from {after[0]['restored_from']}), want "
                                 f"1..{spec.kill_after} then a resume from the step-{last_commit} commit")
        _check_equal("losses of the killed run", [m["loss"] for m in before + after],
                     [want_kill[m["step"] - 1] for m in before + after])
        shards = [os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(storage) for f in fs
                  if f.startswith("shard_") and f.endswith(".pkl")]
        steady = before[1:] + after[1:]  # the first step of each incarnation warms up
        with_save = [m["ms"] for m in steady if m["save_in_flight"]]
        without = [m["ms"] for m in steady if not m["save_in_flight"]]
        B, S = spec.kill[2]
        log(f"trainer kill: {spec.kill[0]} {spec.kill[1]} B={B} S={S}, {spec.kill_steps} steps, an elastic "
            f"checkpoint every {spec.save_every}: worker {killed['pid']} SIGKILLed after step {spec.kill_after}; "
            f"the gang restarted on worker {after[0]['pid']} from the step-{last_commit} commit; restart "
            f"{after[0]['t'] - killed['t']:.2f} s from the kill to the first report after the resume (the new "
            f"worker's loop began {after[0]['t_loop'] - killed['t']:.2f} s after the kill, its restore took "
            f"{after[0]['restore_s']:.2f} s); every loss equals the unkilled run's bit for bit "
            f"({want_kill[0]:.6f} -> {want_kill[-1]:.6f}); checkpoint "
            f"{(sum(shards) / max(len(shards), 1)) / 2**20:.1f} MB per commit ({len(shards)} kept); save() blocked "
            f"{[round(m['block_ms'], 1) for m in saves]} ms; step ms with a save in flight "
            f"{[round(x, 1) for x in with_save]}, without {[round(x, 1) for x in without]}")
    finally:
        left = _end_session(controller, session_dir)
        import shutil

        shutil.rmtree(storage, ignore_errors=True)
    if left:
        raise AssertionError(f"trainer: processes outlived shutdown (killed): {left}")
    launches["trainer"] = counts
    log(f"trainer launches (the trainer's steps, the pipeline parity's card side) {counts}")
    if on_card and not all(counts.get(k, 0) > 0 for k in _kernels()):
        raise AssertionError(f"trainer: a kernel of the path was not launched: {counts}")
    return gpipe


# ------------------------------------------------------------------ mpmd
MPMD_ADAMW = dict(lr=3e-4, weight_decay=0.1)


@dataclasses.dataclass
class MPMDSpec:
    """What the mpmd phase trains, each job (model, overrides, (B, S)) as
    in `TrainerSpec`: `pipe` the 1F1B cell (the trainer phase's GPipe cell:
    S stages, dp=1, M microbatches; run again with `chunks` chunks per
    stage), `parity` the card-vs-CPU check in the driver, `kill` the ZeRO
    run over dp whose stage-1 replica is SIGKILLed after the `kill_after`
    result (and its unkilled replicated twin). `device` None: the card; the
    CPU rehearsal (tests/test_torch_chip_smoke.py) passes tiny models on
    "cpu"."""

    pipe: tuple = ("llama-7b", {"n_layers": 4}, (8, 512))
    stages: int = 2
    micro: int = 4
    chunks: int = 2
    warm: int = 2
    timed: int = 4
    # The 1F1B runs' batches: step s takes batch s mod `pool`. On a new
    # batch every step the loss rose at llama-7b widths (11.17 -> 11.47 in
    # 6 steps on an H100): each AdamW step at lr 3e-4 fits its own batch.
    pool: int = 2
    parity: tuple = ("llama-7b", {"n_layers": 2, "dtype": "float32"}, (2, 128))
    parity_micro: int = 2
    parity_steps: int = 2
    kill: tuple = ("gpt2-large", {"n_layers": 4}, (8, 1024))
    kill_micro: int = 2
    kill_dp: int = 2
    kill_steps: int = 6
    kill_after: int = 3
    ckpt_every: int = 2
    adamw: dict = dataclasses.field(default_factory=lambda: dict(MPMD_ADAMW))
    init: dict = dataclasses.field(default_factory=lambda: {"log_to_driver": False})
    device: str | None = None


def mpmd_launches(cfg, S: int, v: int, M: int, dp: int) -> dict:
    """Kernel launches of one MPMD step, predicted from the schedule: each
    non-last chunk runs its forward twice per microbatch (the F op, and the
    recompute in `fwd_bwd`), the last chunk once (in `loss_bwd`); remat
    "attn" saves the flash outputs, so the checkpointed block's backward
    recomputes the RMSNorms but no flash forward; every layer runs one dQ
    and one dK/dV; the last chunk adds the final RMSNorm."""
    P, L = S * v, cfg.n_layers
    l = L // P
    remat = 1 if cfg.remat else 0
    flash_remat = 1 if cfg.remat and cfg.remat_policy != "attn" else 0
    r = 2 if cfg.norm == "rmsnorm" else 0
    fwd = (P - 1) * l * (2 + flash_remat) + l * (1 + flash_remat)
    rms = (P - 1) * r * l * (2 + remat) + (r * l * (1 + remat) + (1 if r else 0))
    n = M * dp
    return {"flash_fwd": n * fwd, "flash_bwd_dq": n * L, "flash_bwd_dkv": n * L, "rmsnorm": n * rms}


def _mpmd_batch(cfg, shape, seed: int):
    """[B, S+1] int64 tokens drawn by numpy from `seed` (a step of a run),
    skewed toward low ids (V·u³, u uniform): a unigram a model learns in a
    few steps, so the loss falls on a new batch every step."""
    import numpy as np

    B, S = shape
    u = np.random.default_rng(seed).random((B, S + 1))
    return (cfg.vocab_size * u ** 3).astype(np.int64)


def _mpmd_parity(spec: MPMDSpec, counts: dict) -> None:
    """run_local_pipeline on the card against the CPU from the same params
    and batches, f32, TF32 off: losses 1e-5, grad norms 1e-4 (relative)."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train.mpmd import run_local_pipeline

    on_card = spec.device is None
    cfg = _trainer_cfg(spec.parity)
    params = gpt.init_params(cfg, seed=11, device="cpu")
    batches = [_mpmd_batch(cfg, spec.parity[2], 20 + s) for s in range(spec.parity_steps)]
    M = spec.parity_micro
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for name in ("cpu", "card"):
            dev = "cuda" if name == "card" and on_card else "cpu"
            t0 = time.perf_counter()
            with counted(counts) if name == "card" else contextlib.nullcontext({}) as run:
                res = run_local_pipeline(cfg, spec.stages, 1, M, batches, params=params, device=dev,
                                         **spec.adamw)
            out[name] = ([h["loss"] for h in res["history"]], [h["grad_norm"] for h in res["history"]],
                         time.perf_counter() - t0)
            del res
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del params
    (lc, nc, tc), (lg, ng, tg_) = out["cpu"], out["card"]
    loss_d = max(abs(g - c) / abs(c) for g, c in zip(lg, lc))
    norm_d = max(abs(g - c) / abs(c) for g, c in zip(ng, nc))
    want = {k: n * spec.parity_steps for k, n in mpmd_launches(cfg, spec.stages, 1, M, 1).items()}
    log(f"mpmd parity f32 {spec.parity[0]} {spec.parity[1]} B,S={spec.parity[2]} M={M} S={spec.stages}, "
        f"{spec.parity_steps} steps, run_local_pipeline card vs CPU: losses {[round(x, 6) for x in lg]} vs "
        f"{[round(x, 6) for x in lc]} (worst rel diff {loss_d:.2e}), grad norms worst rel diff {norm_d:.2e}; "
        f"card {tg_:.1f} s, CPU {tc:.1f} s; launches on the card {run} (predicted {want})")
    if loss_d > 1e-5 or norm_d > 1e-4:
        raise AssertionError(f"mpmd parity: loss rel diff {loss_d:.2e} (tol 1e-5), grad norm {norm_d:.2e} "
                             "(tol 1e-4)")
    if on_card and run != want:
        raise AssertionError(f"mpmd parity: launches {run}, predicted {want}")
    if on_card:
        torch.cuda.empty_cache()


def _mpmd_fit(cfg, spec: MPMDSpec, storage: str, name: str, job: tuple, seed: int, batch_seed: int,
              steps: int, batch_hook=None, holder: dict | None = None, pool: int | None = None, **options):
    """One MPMDTrainer.fit() (a fresh gang of GPU-worker stage actors).
    Step s takes the batch of seed `batch_seed + s` (with `pool`, of
    `batch_seed + s % pool`: a few batches seen again, so the loss falls as
    the model fits them); `batch_hook(step)` runs in the driver before each
    step's batch, and `holder["trainer"]` is the trainer while it runs."""
    from ray_tpu_torch.train import FailureConfig, RunConfig
    from ray_tpu_torch.train.mpmd import MPMDOptions, MPMDTrainer

    def batch_fn(step):
        if batch_hook is not None:
            batch_hook(step)
        return _mpmd_batch(cfg, job[2], batch_seed + (step % pool if pool else step))

    opts = MPMDOptions(**{"num_stages": spec.stages, "seed": seed, "device": spec.device, "step_timeout_s": 600.0,
                          "channel_timeout_s": 600.0, "ckpt_every": 10 ** 6, **spec.adamw, **options})
    trainer = MPMDTrainer(cfg, opts, steps, batch_fn,
                          run_config=RunConfig(storage_path=storage, name=name,
                                               failure_config=FailureConfig(max_failures=1, backoff_base_s=1.0)),
                          experiment_name=name)
    if holder is not None:
        holder["trainer"] = trainer
    t0 = time.perf_counter()
    res = trainer.fit()
    res["fit_s"] = time.perf_counter() - t0
    if res["error"]:
        raise AssertionError(f"mpmd {name}: the run failed: {res['error']}")
    return res


def _mpmd_step_launches(h) -> dict:
    """A step's launches, summed over the replicas that counted them."""
    out: dict = {}
    for m in h["replicas"].values():
        for k, n in m["launches"].items():
            out[k] = out.get(k, 0) + n
    return out


def _mpmd_sum(counts: dict, history) -> None:
    for h in history:
        for k, n in _mpmd_step_launches(h).items():
            counts[k] = counts.get(k, 0) + n


def _mpmd_bytes(history, key: str) -> float:
    """Bytes sent per step over the edges (`wire`) or the bridge, over the
    run's steps after the first (the counters are cumulative per actor)."""
    per = []
    for a, b in zip(history, history[1:]):
        if a["dp"] != b["dp"] or b["step"] != a["step"] + 1:
            continue
        per.append(sum(b["replicas"][r].get(key, {}).get("raw_bytes", 0) -
                       a["replicas"][r].get(key, {}).get("raw_bytes", 0) for r in b["replicas"]))
    return sum(per) / max(len(per), 1)


def _wait_card_released(free_before, what: str) -> None:
    """Wait (up to 60 s) for the card's memory to come back after a gang's
    actors were killed: a GPU worker frees its memory once it is reaped."""
    import torch

    if free_before is None:
        return
    deadline = time.monotonic() + 60
    while torch.cuda.mem_get_info()[0] < free_before - MEMORY_RELEASE_SLACK and time.monotonic() < deadline:
        time.sleep(0.25)
    free = torch.cuda.mem_get_info()[0]
    if free < free_before - MEMORY_RELEASE_SLACK:
        raise AssertionError(f"mpmd {what}: the card's memory was not released ({free / 2**30:.2f} GiB free, "
                             f"{free_before / 2**30:.2f} before)")


def phase_mpmd(launches: dict, gpipe: dict | None = None, spec: MPMDSpec | None = None) -> None:
    """MPMD pipeline training on the copied runtime: `ray_tpu_torch.init()`
    in cluster mode, `MPMDTrainer` gangs of GPU-worker stage actors
    (num_gpus=1/(S*dp) each) exchanging activations and gradients over
    compiled-DAG edges, each stage's dp replicas running the ZeRO update
    over the host-plane collectives. The 1F1B cell (the trainer phase's
    GPipe cell) and its interleaved twin; the card-vs-CPU parity in the
    driver; gpt2-large widths at dp=2 (tied: the bridge runs) with a
    stage-1 replica SIGKILLed after the `kill_after` result, resumed at the
    common commit. Launches are counted in each actor, per step."""
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train.elastic import latest_common_committed
    from ray_tpu_torch.train.mpmd import theoretical_bubble_fraction

    spec = spec or MPMDSpec()
    on_card = spec.device is None
    counts: dict = {}
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
        log(f"mpmd: driver device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free")

    # 1. The driver's own work first, each freed before the next: the
    # pipeline's parity, then loss_fn of the 1F1B cell's first batch.
    _mpmd_parity(spec, counts)
    cfg = _trainer_cfg(spec.pipe)
    S, M, v = spec.stages, spec.micro, spec.chunks
    steps = spec.warm + spec.timed
    dev = "cuda" if on_card else "cpu"
    params = gpt.init_params(cfg, seed=7, device="cpu")
    with torch.no_grad():
        full = {k: t.to(dev) for k, t in params.items()}
        serial = gpt.loss_fn(full, {"tokens": torch.as_tensor(_mpmd_batch(cfg, spec.pipe[2], 100)).to(dev)},
                             cfg).item()
    del params, full
    if on_card:
        torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0] if on_card else None

    storage = tempfile.mkdtemp(prefix="rtput-mpmd-")
    t0 = time.perf_counter()
    rt.init(**spec.init)
    backend = api._global_runtime().backend
    session_dir, controller = backend.session_dir, backend._controller_proc.pid
    try:
        log(f"mpmd: cluster up in {time.perf_counter() - t0:.2f} s, resources {rt.cluster_resources()}")

        # 2. 1F1B and interleaved 1F1B at llama-7b widths.
        runs = {}
        for chunks in (1, v):
            res = _mpmd_fit(cfg, spec, storage, f"pipe-v{chunks}", spec.pipe, seed=7, batch_seed=100, steps=steps,
                            pool=spec.pool, dp=1, num_microbatches=M, num_chunks=chunks, zero=True,
                            num_gpus_per_replica=1.0 / S)
            runs[chunks] = res
            _wait_card_released(free_before, f"pipe v={chunks}")
        B, Sq = spec.pipe[2]
        for chunks, res in runs.items():
            hist = res["history"]
            _mpmd_sum(counts, hist)
            timed = hist[spec.warm:]
            step_s = sum(h["wall_s"] for h in timed) / len(timed)
            want = mpmd_launches(cfg, S, chunks, M, 1)
            per_stage = {s: (sum(h["replicas"][f"s{s}r0"]["busy_s"] for h in timed) / len(timed),
                             sum(h["replicas"][f"s{s}r0"]["update_s"] for h in timed) / len(timed))
                         for s in range(S)}
            bubble = sum(h["bubble_frac"] for h in timed) / len(timed)
            against = "" if not gpipe else \
                f"; the GPipe cell {gpipe['step_ms']:.1f} ms, {gpipe['tokens_per_s']:.1f} tokens/s"
            log(f"mpmd 1F1B {spec.pipe[0]} {spec.pipe[1]} B={B} S={Sq} M={M} stages={S} v={chunks} dp=1 ZeRO: loss "
                f"{hist[0]['loss']:.6f} -> {hist[-1]['loss']:.6f} over {len(hist)} steps; step "
                f"{step_s * 1e3:.1f} ms, {B * Sq / step_s:.1f} tokens/s (mean of {len(timed)} after {spec.warm} "
                f"warm-up){against}; "
                f"per stage busy_s, update_s {({s: (round(b, 4), round(u, 4)) for s, (b, u) in per_stage.items()})}; "
                f"bubble {bubble:.4f} (theory {theoretical_bubble_fraction(S, M, chunks):.4f}: one card, the stages "
                f"time-slice it); edge bytes per step {_mpmd_bytes(hist, 'wire') / 2**20:.1f} MiB; fit() "
                f"{res['fit_s']:.1f} s; launches per step {_mpmd_step_launches(hist[-1])} (predicted {want})")
            if on_card:
                bad = [_mpmd_step_launches(h) for h in hist if _mpmd_step_launches(h) != want]
                if bad:
                    raise AssertionError(f"mpmd v={chunks}: launches per step {bad[0]}, predicted {want}")
        one = runs[1]["history"]
        rel = abs(one[0]["loss"] - serial) / abs(serial)
        log(f"mpmd 1F1B first loss {one[0]['loss']:.6f} vs loss_fn {serial:.6f} (rel diff {rel:.2e})")
        if rel > 2e-3 or not (math.isfinite(one[-1]["loss"]) and one[-1]["loss"] < one[0]["loss"]):
            raise AssertionError(f"mpmd 1F1B: first loss {rel:.2e} from loss_fn (tol 2e-3), or the loss "
                                 f"{one[0]['loss']} -> {one[-1]['loss']} is not finite and falling")
        l1, l2 = [h["loss"] for h in one], [h["loss"] for h in runs[v]["history"]]
        worst = max(abs(a - b) / abs(a) for a, b in zip(l1, l2))
        log(f"mpmd interleaved v={v} losses vs v=1: "
            f"{'bit for bit' if l1 == l2 else 'NOT bit-equal'} (worst rel diff {worst:.2e})")
        if worst > 1e-3 or len(l1) != len(l2):
            raise AssertionError(f"mpmd interleaved: losses {l2} vs v=1 {l1} (tol 1e-3)")

        # 3. ZeRO over dp with the bridge: the unkilled replicated run, then
        # the ZeRO run with a stage-1 replica SIGKILLed.
        kcfg = _trainer_cfg(spec.kill)
        D = spec.kill_dp
        common = dict(dp=D, dp_min=1, dp_max=D, num_microbatches=spec.kill_micro, num_chunks=1,
                      num_gpus_per_replica=1.0 / (S * D))
        plain = _mpmd_fit(kcfg, spec, storage, "zero-off", spec.kill, seed=9, batch_seed=300, steps=spec.kill_steps,
                          zero=False, **common)
        _wait_card_released(free_before, "zero-off")
        _mpmd_sum(counts, plain["history"])
        want_losses = [h["loss"] for h in plain["history"]]
        known = _descendants(controller)
        killed: dict = {}
        holder: dict = {}
        commit = spec.kill_after - spec.kill_after % spec.ckpt_every
        calls = []

        def kill_hook(step):
            calls.append((step, time.time()))
            if step != spec.kill_after or killed:
                return
            trainer = holder["trainer"]
            root = trainer.run_config.resolve_storage()
            deadline = time.monotonic() + 120
            while (latest_common_committed(root, S) or (0,))[0] < commit and time.monotonic() < deadline:
                time.sleep(0.05)
            pid = api.get(trainer.gang.actors[(1, 0)].pid.remote(), timeout=60)
            ours = {p for p, _ in _session_processes({**known, **_descendants(controller)}, session_dir)}
            if pid not in ours:
                raise AssertionError(f"mpmd kill: pid {pid} is not a process of this session")
            os.kill(pid, 9)
            killed["t"], killed["pid"] = time.time(), pid

        res = _mpmd_fit(kcfg, spec, storage, "zero-kill", spec.kill, seed=9, batch_seed=300, steps=spec.kill_steps,
                        batch_hook=kill_hook, holder=holder, zero=True, ckpt_every=spec.ckpt_every, **common)
        _wait_card_released(free_before, "zero-kill")
        hist = res["history"]
        _mpmd_sum(counts, hist)
        sup = holder["trainer"]._supervisor
        got_steps = [h["step"] for h in hist]
        want_steps = list(range(1, spec.kill_after + 1)) + list(range(commit + 1, spec.kill_steps + 1))
        if "t" not in killed or got_steps != want_steps or res["attempts"] < 1:
            raise AssertionError(f"mpmd kill: killed {killed}, steps {got_steps} (want {want_steps}), attempts "
                                 f"{res['attempts']}")
        new_dp = hist[-1]["dp"]
        resumed = [t for s, t in calls if t > killed["t"]]
        restart_s = resumed[1] - killed["t"] if len(resumed) > 1 else float("nan")
        same = [h["loss"] for h in hist] == [want_losses[s - 1] for s in got_steps]
        pre = [h["loss"] for h in hist[:spec.kill_after]] == want_losses[:spec.kill_after]
        worst = max(abs(h["loss"] - want_losses[h["step"] - 1]) / abs(want_losses[h["step"] - 1]) for h in hist)
        zb = max(h["opt_bytes_per_replica"] for h in hist[:spec.kill_after])
        rb = plain["history"][0]["opt_bytes_per_replica"]
        upd = {r: round(sum(h["replicas"][r]["update_s"] for h in hist[1:spec.kill_after]) /
                        max(spec.kill_after - 1, 1), 4) for r in hist[0]["replicas"]}
        Bk, Sk = spec.kill[2]
        log(f"mpmd kill: {spec.kill[0]} {spec.kill[1]} B={Bk} S={Sk} M={spec.kill_micro} stages={S} dp={D} ZeRO, tied "
            f"(bridge), checkpoint every {spec.ckpt_every}: stage-1 replica 0 (pid {killed['pid']}) SIGKILLed after "
            f"the step-{spec.kill_after} result; the mesh aborted, the gang re-spawned at dp={new_dp} "
            f"(_pick_dp), restored at the common commit {commit} and ran to step {got_steps[-1]}; restart "
            f"{restart_s:.2f} s from the kill to the first result after the resume (supervisor recovery "
            f"{sup.last_recovery_s:.2f} s); losses {'equal' if same else 'DIFFER from'} the unkilled replicated "
            f"run's at dp={D} bit for bit (worst rel diff {worst:.2e}; before the kill "
            f"{'bit for bit' if pre else 'not bit-equal'}); optimizer bytes per replica {zb / 2**20:.1f} MiB ZeRO vs "
            f"{rb / 2**20:.1f} MiB replicated ({rb / zb:.3f}x); update_s by replica {upd}; step "
            f"{sum(h['wall_s'] for h in hist[1:spec.kill_after]) / max(spec.kill_after - 1, 1) * 1e3:.1f} ms; "
            f"bridge bytes per step {_mpmd_bytes(hist[:spec.kill_after], 'bridge') / 2**20:.1f} MiB, edge "
            f"{_mpmd_bytes(hist[:spec.kill_after], 'wire') / 2**20:.1f} MiB; launches per step "
            f"{_mpmd_step_launches(hist[0])} (predicted {mpmd_launches(kcfg, S, 1, spec.kill_micro, D)})")
        if not pre or (new_dp == D and not same) or worst > 1e-3:
            raise AssertionError(f"mpmd kill: losses {[h['loss'] for h in hist]} vs unkilled {want_losses}")
        if not 1.9 < rb / zb < 2.1:
            raise AssertionError(f"mpmd kill: replicated/ZeRO optimizer bytes {rb / zb:.3f}, want 1.9-2.1")
        if on_card:
            for h in hist + plain["history"]:
                want = mpmd_launches(kcfg, S, 1, spec.kill_micro, h["dp"])
                if _mpmd_step_launches(h) != want:
                    raise AssertionError(f"mpmd kill: launches per step {_mpmd_step_launches(h)}, predicted {want}")
    finally:
        left = _end_session(controller, session_dir)
        shutil.rmtree(storage, ignore_errors=True)
    if left:
        raise AssertionError(f"mpmd: processes outlived shutdown (killed): {left}")
    launches["mpmd"] = counts
    log(f"mpmd launches (the trainers' steps, the parity's card side) {counts}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    if on_card and not all(counts.get(k, 0) > 0 for k in _kernels()):
        raise AssertionError(f"mpmd: a kernel of the path was not launched: {counts}")


# ------------------------------------------------------------------ parallel
MOE_TRAIN_SHAPE = (8, 1024)   # B, S of the gpt2-medium-moe step
MOE_PARITY_SHAPE = (2, 128)
CP_SHAPE = (2, 1024)          # ring / Ulysses forwards at llama-7b widths, 2 layers


def _one_rank_world(backend: str = "nccl") -> None:
    """A world of one rank, its store on a free local port; on card 0
    unless the backend is gloo alone ("cpu:gloo,cuda:nccl" serves meshes
    of both device types)."""
    import socket

    import torch
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    kwargs = {}
    if backend != "gloo":
        torch.cuda.set_device(0)
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", 0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=1, rank=0, **kwargs)


def _placed(params: dict, cfg, mesh) -> dict:
    from ray_tpu_torch.models.gpt import param_shardings
    from ray_tpu_torch.parallel import place

    shardings = param_shardings(cfg, mesh)
    return {k: place(v, mesh, shardings[k]).detach() for k, v in params.items()}


def _moe_train(mesh, counts: dict) -> None:
    """gpt2-medium-moe at full width, B=8 x S=1024, through the mesh."""
    import torch

    from ray_tpu_torch.models.gpt import gpt2_medium, init_params, make_train_step
    from ray_tpu_torch.optim import AdamW

    B, S = MOE_TRAIN_SHAPE
    cfg = gpt2_medium(mlp_type="moe", max_seq=S, remat=True, remat_policy="attn")
    params = _placed(init_params(cfg, seed=0, device="cuda"), cfg, mesh)  # f32 master weights
    n = sum(p.numel() for p in params.values())
    step = make_train_step(cfg, AdamW(params.values(), lr=3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16),
                           mesh=mesh)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1), device="cuda",
                                     generator=torch.Generator(device="cuda").manual_seed(1))}
    n_steps, L = 5, cfg.n_layers
    per_step = []
    with counted(counts):
        t0 = time.perf_counter()
        _, metrics = step(params, batch)
        first_loss = metrics["loss"].item()
        step(params, batch)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            before = read_launches()
            _, metrics = step(params, batch)
            per_step.append({k: c - before[k] for k, c in read_launches().items()})
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n_steps
        _profile(f"parallel moe train gpt2-medium-moe B={B} S={S}, one step", lambda: step(params, batch))
    final_loss = metrics["loss"].item()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"parallel moe train gpt2-medium-moe (8 experts, top-2, capacity 1.25) B={B} S={S} bf16 compute, "
        f"f32 master, remat=attn, AdamW bf16 mu, mesh of one rank: {B * S / dt:.1f} tokens/s, step "
        f"{dt * 1e3:.2f} ms, peak memory {peak:.2f} GiB, loss {first_loss:.4f} (step 1) -> {final_loss:.4f} "
        f"(step 7), grad_norm {metrics['grad_norm'].item():.4f}, {n / 1e9:.3f} B params, warm-up 2 steps "
        f"{warm:.1f} s; launches per step {per_step[-1]}")
    if not (math.isfinite(final_loss) and final_loss < first_loss):
        raise AssertionError(f"parallel moe train: loss {first_loss} -> {final_loss} is not finite and falling")
    want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L, "rmsnorm": 0}
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"parallel moe train step {i}: launches {c}, want {want}")
    del params, step
    torch.cuda.empty_cache()


def _moe_parity(mesh, counts: dict) -> None:
    """gpt2-medium-moe widths at 2 layers, f32, TF32 off: loss and every
    gradient of the mesh path on the card against the plain CPU run."""
    import torch

    from ray_tpu_torch.models.gpt import gpt2_medium, init_params, loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S = MOE_PARITY_SHAPE
    cfg = gpt2_medium(mlp_type="moe", n_layers=2, max_seq=S, dtype=torch.float32, remat=True,
                      remat_policy="attn")
    cpu = init_params(cfg, seed=1, device="cpu")
    gpu = _placed({k: v.cuda() for k, v in cpu.items()}, cfg, mesh)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=torch.Generator().manual_seed(5))
    for p in (*cpu.values(), *gpu.values()):
        p.requires_grad_(True)
    t0 = time.perf_counter()
    loss_cpu = loss_fn(cpu, {"tokens": tokens}, cfg)
    loss_cpu.backward()
    t_cpu = time.perf_counter() - t0
    with counted(counts) as run:
        loss_gpu = loss_fn(gpu, {"tokens": tokens.cuda()}, cfg, mesh=mesh)
        loss_gpu.backward()
    lg, lc = loss_gpu.full_tensor().item(), loss_cpu.item()
    loss_d = abs(lg - lc) / abs(lc)
    errs = {k: (gpu[k].grad.full_tensor().cpu() - p.grad).abs().max().item() / max(p.grad.abs().max().item(), 1e-30)
            for k, p in cpu.items() if p.grad is not None}
    worst = max(errs, key=errs.get)
    log(f"parallel moe parity f32 gpt2-medium-moe widths L=2 B={B} S={S} remat=attn, card (mesh) vs CPU: loss "
        f"{lg:.6f} vs {lc:.6f} (rel diff {loss_d:.2e}); grads max|d|/max|ref|: worst {errs[worst]:.2e} "
        f"({worst}), router {errs['moe_router']:.2e}, experts in/out {errs['moe_w_in']:.2e}/"
        f"{errs['moe_w_out']:.2e}; one CPU step {t_cpu:.1f} s; launches on the card {run}")
    missing = sorted(k for k, p in cpu.items() if (p.grad is None) != (gpu[k].grad is None))
    if missing or loss_d > 1e-5 or errs[worst] > 1e-4:
        raise AssertionError(f"parallel moe parity: loss rel diff {loss_d:.2e} (tol 1e-5), grad {worst} "
                             f"{errs[worst]:.2e} (tol 1e-4), gradient on one side only {missing}")
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers, "rmsnorm": 0}
    if run != want:
        raise AssertionError(f"parallel moe parity: launches {run}, want {want}")
    del cpu, gpu
    torch.cuda.empty_cache()


def _timed_steps(step, params, batch, n: int):
    """(first step's loss, the last step's metrics, seconds per step over n
    steps after two)."""
    import torch

    first = step(params, batch)[1]["loss"].item()
    step(params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        metrics = step(params, batch)[1]
    torch.cuda.synchronize()
    return first, {k: v.item() for k, v in metrics.items()}, (time.perf_counter() - t0) / n


def _sharded_step(mesh, counts: dict) -> None:
    """The train phase's gpt2-large step through the mesh against the plain
    step from the same params and batch: the first loss within 1e-4; after
    the 2 + 4 steps the loss, grad_norm and the update of every param within
    the bf16 bar; and each one's tokens/s."""
    import torch

    from ray_tpu_torch.models.gpt import gpt2_large, init_params, make_train_step
    from ray_tpu_torch.optim import AdamW

    B, S, n = 13, 1024, 4
    cfg = gpt2_large(max_seq=S, attn_impl="flash", remat=True, remat_policy="attn")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1), device="cuda",
                                     generator=torch.Generator(device="cuda").manual_seed(1))}
    init = init_params(cfg, seed=0, device="cuda")
    out, after = {}, {}
    for name in ("plain", "mesh"):
        params = {k: v.clone() for k, v in init.items()}
        on = mesh if name == "mesh" else None
        if on is not None:
            params = _placed(params, cfg, mesh)
        step = make_train_step(cfg, AdamW(params.values(), lr=3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16),
                               mesh=on)
        with counted(counts) if on is not None else contextlib.nullcontext({}) as run:
            out[name] = _timed_steps(step, params, batch, n)
        after[name] = {k: (v.full_tensor() if on is not None else v).detach() for k, v in params.items()}
        del params, step
        torch.cuda.empty_cache()
    (lp, mp, tp), (lm, mm, tm) = out["plain"], out["mesh"]
    num = sum(float((after["mesh"][k] - after["plain"][k]).double().square().sum()) for k in init)
    den = sum(float((after["plain"][k] - init[k]).double().square().sum()) for k in init)
    upd = (num / max(den, 1e-300)) ** 0.5
    rel = {"first loss": abs(lm - lp) / abs(lp), "last loss": abs(mm["loss"] - mp["loss"]) / abs(mp["loss"]),
           "last grad_norm": abs(mm["grad_norm"] - mp["grad_norm"]) / abs(mp["grad_norm"]), "update": upd}
    log(f"parallel sharded step gpt2-large B={B} S={S} at one rank, mesh vs plain from the same params: first loss "
        f"{lm:.6f} vs {lp:.6f}; after {2 + n} steps loss {mm['loss']:.6f} vs {mp['loss']:.6f}, grad_norm "
        f"{mm['grad_norm']:.6f} vs {mp['grad_norm']:.6f}; relative differences {rel}; mesh {B * S / tm:.1f} "
        f"tokens/s ({tm * 1e3:.2f} ms/step), plain {B * S / tp:.1f} tokens/s ({tp * 1e3:.2f} ms/step), {n} steps "
        f"each after two; mesh launches {run}")
    bars = {"first loss": 1e-4, "last loss": TOL["bf16"], "last grad_norm": TOL["bf16"], "update": TOL["bf16"]}
    over = {k: v for k, v in rel.items() if not v <= bars[k]}
    if over:
        raise AssertionError(f"parallel sharded step: mesh vs plain {over} over the bars {bars}")
    L = cfg.n_layers
    want = {"flash_fwd": (2 + n) * L, "flash_bwd_dq": (2 + n) * L, "flash_bwd_dkv": (2 + n) * L, "rmsnorm": 0}
    if run != want:
        raise AssertionError(f"parallel sharded step: mesh launches {run}, want {want}")
    del init, after
    torch.cuda.empty_cache()


def _context_parallel(mesh, counts: dict) -> None:
    """llama-7b widths, 2 layers, bf16: Ulysses through the mesh equals the
    flash forward exactly. Ring keeps P in f32 where flash rounds it to
    bf16, so the two differ by bf16 rounding carried through two layers and
    the LM head: ring's attention core is held to the flash kernel's bf16
    bar on one call, and its logits must be no further from the f32 model's
    than 1.5× the bf16 flash forward's are. Each forward through the mesh
    runs the RMSNorm kernel; Ulysses runs the flash forward once a layer."""
    import torch

    from ray_tpu_torch.models.gpt import forward, init_params, llama_7b
    from ray_tpu_torch.ops.attention import flash_attention, ring_attention
    from ray_tpu_torch.parallel import use_mesh

    B, S = CP_SHAPE
    cfg = llama_7b(n_layers=2, max_seq=S)
    plain = init_params(cfg, seed=2, device="cuda", dtype=torch.bfloat16)
    placed = _placed(plain, cfg, mesh)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4))
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn((B, cfg.n_heads, S, cfg.d_head), generator=gen, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    with torch.no_grad(), use_mesh(mesh):
        compare("parallel ring vs flash attention core (llama-7b layer shape)",
                ring_attention(q, k, v, axis="sp"), flash_attention(q, k, v), TOL["bf16"])
    with torch.no_grad():
        want = forward(plain, tokens, cfg)
        exact = forward({k: w.float() for k, w in plain.items()}, tokens,
                        dataclasses.replace(cfg, dtype=torch.float32))
        got, runs = {}, {}
        for impl in ("ulysses", "ring"):
            with counted(counts) as runs[impl]:
                got[impl] = forward(placed, tokens, dataclasses.replace(cfg, attn_impl=impl), mesh=mesh).full_tensor()
    torch.cuda.synchronize()
    same = torch.equal(got["ulysses"], want)
    err = {name: (t.float() - exact).abs().max().item() for name, t in (("flash", want), ("ring", got["ring"]))}
    log(f"parallel context parallelism llama-7b widths L=2 B={B} S={S} bf16, sp=1: Ulysses equals the flash "
        f"forward bit for bit: {same} (max |d| {(got['ulysses'].float() - want.float()).abs().max().item():.3e}); "
        f"max |logit - f32 model|: flash {err['flash']:.3e}, ring {err['ring']:.3e}; ring vs flash max |d| "
        f"{(got['ring'].float() - want.float()).abs().max().item():.3e}; launches {runs}")
    L = cfg.n_layers
    if runs["ulysses"]["flash_fwd"] != L or any(r["rmsnorm"] <= 0 for r in runs.values()):
        raise AssertionError(f"parallel: launches {runs}, want {L} flash forwards in Ulysses and RMSNorm in both")
    if not same:
        raise AssertionError("parallel: Ulysses at sp=1 differs from the flash forward")
    if err["ring"] > 1.5 * err["flash"]:
        raise AssertionError(f"parallel: ring's logits are {err['ring']:.3e} from the f32 model's, more than "
                             f"1.5x the flash forward's {err['flash']:.3e}")
    del plain, placed
    torch.cuda.empty_cache()


def phase_parallel(launches: dict) -> None:
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import make_mesh

    _one_rank_world()
    try:
        mesh = make_mesh()
        log(f"parallel: backend {dist.get_backend()}, world size {dist.get_world_size()}, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} on {mesh.device_type}")
        counts: dict = {}  # the launches of the mesh runs only
        _moe_train(mesh, counts)
        _moe_parity(mesh, counts)
        _sharded_step(mesh, counts)
        _context_parallel(mesh, counts)
        launches["parallel"] = counts
        log(f"parallel launches (the mesh runs) {counts}")
    finally:
        dist.destroy_process_group()


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


# The engine phase's options; the serve phase's colocated replica runs the same.
ENGINE_OPTIONS = dict(num_blocks=512, block_size=16, max_num_seqs=8)
ENGINE_MAX_TOKENS = 32
LONE_REQUESTS = 4  # prompts also served alone (and the first once more), for the serve phase


def _lone_runs(engine, prompts: list, n: int) -> list:
    """(tokens, TTFT s) of each prompt served alone by an otherwise idle
    engine, one after another, and then the first prompt once more (a
    prefix-cache hit, as the serve phase's HTTP request is)."""
    out = []
    for p in prompts + prompts[:1]:
        rid = engine.submit(p, n)
        seq = engine.scheduler.get(rid)
        _drain(engine)
        out.append((list(engine.stream(rid)), seq.first_token_t - seq.arrival_t))
    return out


def phase_engine(cfg, params, launches: dict) -> dict:
    """The continuous-batching engine on llama-7b; returns what the serve
    phase holds its replicas to: the requests and their batched tokens, the
    tokens/s, and the tokens of LONE_REQUESTS prompts each served alone by a
    fresh engine (the replica's state on its first requests)."""
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
    max_tokens = ENGINE_MAX_TOKENS
    engine = InferenceEngine(cfg, params, EngineOptions(**ENGINE_OPTIONS), device="cuda")
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

    del engine, spec
    torch.cuda.empty_cache()
    lone_engine = InferenceEngine(cfg, params, EngineOptions(**ENGINE_OPTIONS), device="cuda")
    _finite_guard(lone_engine)
    lone = _lone_runs(lone_engine, prompts[:LONE_REQUESTS], max_tokens)
    del lone_engine
    torch.cuda.empty_cache()
    log(f"engine: {LONE_REQUESTS} prompts ({[len(p) for p in prompts[:LONE_REQUESTS]]} tokens) served alone by a "
        f"fresh engine, then the first again: TTFT {[round(t * 1e3, 1) for _, t in lone]} ms; the repeat "
        f"{'equals' if lone[-1][0] == lone[0][0] else 'differs from'} the first")
    if any(len(t) != max_tokens for t, _ in lone):
        raise AssertionError(f"engine: lone requests unfinished: {[len(t) for t, _ in lone]}")
    requests = prompts + [first_shared, late_shared]
    return {"requests": requests, "tokens": outs, "max_tokens": max_tokens, "tokens_per_s": total / wall,
            "lone_prompts": prompts[:LONE_REQUESTS], "lone_tokens": [t for t, _ in lone]}


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
        left = _end_session(controller, session_dir)
    if left:
        raise AssertionError(f"runtime: processes outlived shutdown (killed): {left}")


def _end_session(controller: int, session_dir: str, before_shutdown=None) -> list:
    """Shut the runtime down (after `before_shutdown`, e.g. Serve's), wait
    up to 30 s for this session's processes to end, kill any left and
    return them as (pid, parent, command)."""
    import ray_tpu_torch as rt

    known = _descendants(controller)
    try:
        if before_shutdown is not None:
            before_shutdown()
    finally:
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
    return left

# ------------------------------------------------------------------ serve
SERVE_BOOT_TIMEOUT_S = 600.0   # a replica's boot: GPU worker, CUDA, kernel library, llama-7b
SERVE_REQUEST_TIMEOUT_S = 300.0
MEMORY_RELEASE_SLACK = 1 << 30  # bytes of the card the driver may still miss after shutdown


@dataclasses.dataclass
class ServeSpec:
    """What the serve phase deploys: the model, its overrides at full width
    (`full`) and for the f32 parity pair (`parity`), the engine options of
    each, the runtime's init arguments, and where the replicas compute
    (None: the card). The CPU rehearsal (tests/test_torch_chip_smoke.py)
    passes a tiny model on the CPU."""

    model: str = "llama-7b"
    full: dict = dataclasses.field(default_factory=lambda: {"dtype": "bfloat16"})
    parity: dict = dataclasses.field(default_factory=lambda: {"n_layers": 2, "dtype": "float32"})
    engine_options: dict = dataclasses.field(default_factory=lambda: dict(ENGINE_OPTIONS))
    parity_options: dict = dataclasses.field(
        default_factory=lambda: {"num_blocks": 64, "block_size": 16, "max_num_seqs": 8})
    init: dict = dataclasses.field(default_factory=lambda: {"log_to_driver": False})
    device: str | None = None


def _smoke_replica_class():
    """`LLMDeployment`'s replica class with the smoke's instruments added:
    every paged forward of its engine counted and checked finite, each KV
    import timed, and the kernel launch counts of its process read out.
    Serving runs `_LLMReplica`'s own methods."""
    from ray_tpu_torch.serve.engine.deployment import _LLMReplica

    class SmokeLLMReplica(_LLMReplica):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.forwards = {"n": 0}
            self.import_ms = []
            _finite_guard(self.engine, self.forwards)
            real_import = self.engine.import_blocks

            def timed_import(desc):
                t0 = time.perf_counter()
                try:
                    return real_import(desc)
                finally:
                    self.import_ms.append((time.perf_counter() - t0) * 1e3)

            self.engine.import_blocks = timed_import

        def smoke_counts(self, reset: bool = False) -> dict:
            out = {"launches": read_launches(), "forwards": self.forwards["n"], "import_ms": list(self.import_ms)}
            if reset:
                reset_launches()
                self.forwards["n"] = 0
                self.import_ms.clear()
            return out

    return SmokeLLMReplica


def _llm_app(replica_cls, model: str, overrides: dict, engine_options: dict, device, **options):
    """`LLMDeployment.options(**options)` serving `replica_cls`, bound."""
    from ray_tpu_torch.serve import LLMDeployment
    from ray_tpu_torch.serve.deployment import Deployment

    dep = LLMDeployment.options(**options)
    return Deployment(replica_cls, dep.name, dep.opts).bind(
        model=model, model_overrides=overrides, engine_options={**engine_options, "seed": 0}, device=device)


def _replicas(app: str) -> list:
    """(replica actor, role) of the app's LLMDeployment, as its router sees them."""
    from ray_tpu_torch.serve.handle import Router

    router = Router.get_or_create(app, "LLMDeployment")
    router._refresh(force=True)
    with router._lock:
        return list(zip(router._info["replicas"], router._replica_roles()))


def _replica_call(replica, method: str, *args):
    import ray_tpu_torch as rt

    return rt.get(replica.handle_request.remote(method, args, {}), timeout=SERVE_REQUEST_TIMEOUT_S)


def _first_difference(got: list, want: list) -> str:
    i = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    return f"first differing position {i}: {got[i:i + 4]} vs {want[i:i + 4]} ({len(got)} vs {len(want)} tokens)"


def _stream_burst(handle, prompts: list, n: int) -> list:
    """Every prompt streamed through the handle at once: (tokens, TTFT s,
    total s) each, timed at the caller."""
    from concurrent.futures import ThreadPoolExecutor

    def one(p):
        t0, first, toks = time.perf_counter(), None, []
        for tok in handle.options(stream=True).generate_stream.remote(p, n):
            if first is None:
                first = time.perf_counter() - t0
            toks.append(tok)
        return toks, first, time.perf_counter() - t0

    with ThreadPoolExecutor(len(prompts)) as pool:
        futures = [pool.submit(one, p) for p in prompts]
        return [f.result(timeout=SERVE_REQUEST_TIMEOUT_S) for f in futures]


def _check_replica_launches(where: str, counts: dict, n_layers: int, on_card: bool) -> None:
    """A replica's paged forwards run the RMSNorm kernel at every norm and
    attend in plain torch (no flash launch)."""
    nf, nr, fwd = counts["launches"]["flash_fwd"], counts["launches"]["rmsnorm"], counts["forwards"]
    want_nr = (2 * n_layers + 1) * fwd if on_card else 0
    if fwd <= 0 or nf != 0 or nr != want_nr:
        raise AssertionError(f"serve {where}: {fwd} paged forwards, launches flash={nf} (want 0), rmsnorm={nr} "
                             f"(want {want_nr})")


def _post_json(url: str, body: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=SERVE_REQUEST_TIMEOUT_S) as resp:
        return json.loads(resp.read())


def phase_serve(served: dict, launches: dict, spec: ServeSpec | None = None) -> None:
    """llama-7b behind `LLMDeployment` on the port's Serve, in cluster mode:
    one colocated replica on the whole card that must return the engine
    phase's lone-request tokens exactly (through the handle and over HTTP)
    and serve the engine phase's burst; then two disaggregated pairs on
    half the card each (prefill, decode): at the parity phase's f32 model
    the handoff returns the colocated tokens exactly, at full width in bf16
    the decode replica imports every full block of each prompt."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core import api
    from ray_tpu_torch.models.gpt import CONFIGS
    from ray_tpu_torch.serve.engine.engine import EngineOptions, InferenceEngine

    spec = spec or ServeSpec()
    on_card = spec.device is None
    full, parity = spec.full, spec.parity
    engine_options, parity_options = spec.engine_options, spec.parity_options
    cfg = CONFIGS[spec.model](**full)
    n = served["max_tokens"]
    free_before = torch.cuda.mem_get_info()[0] if on_card else None
    serve_launches = {}
    replica_cls = _smoke_replica_class()

    def tally(where: str, replica, n_layers: int) -> dict:
        counts = _replica_call(replica, "smoke_counts")
        _check_replica_launches(where, counts, n_layers, on_card)
        for k, v in counts["launches"].items():
            serve_launches[k] = serve_launches.get(k, 0) + v
        return counts

    t0 = time.perf_counter()
    rt.init(**spec.init)
    backend = api._global_runtime().backend
    session_dir, controller = backend.session_dir, backend._controller_proc.pid
    try:
        serve.start(http_options={"host": "127.0.0.1", "port": 0})
        log(f"serve: cluster and Serve up in {time.perf_counter() - t0:.2f} s, resources {rt.cluster_resources()}")

        # 1. Colocated: one replica on the whole card.
        t0 = time.perf_counter()
        handle = serve.run(_llm_app(replica_cls, spec.model, full, engine_options, spec.device,
                                    ray_actor_options={"num_gpus": 1, "max_concurrency": 16}),
                           name="llm", route_prefix="/llm", timeout_s=SERVE_BOOT_TIMEOUT_S)
        boot_s = time.perf_counter() - t0
        (replica, _), = _replicas("llm")
        _replica_call(replica, "smoke_counts", True)
        log(f"serve: colocated LLMDeployment replica ({spec.model} {full}, num_gpus=1) booted in {boot_s:.2f} s "
            f"(timeout {SERVE_BOOT_TIMEOUT_S:.0f} s)")
        lone_s = []
        for i, (p, want) in enumerate(zip(served["lone_prompts"], served["lone_tokens"])):
            t0 = time.perf_counter()
            got = handle.generate.remote(p, n).result(timeout_s=SERVE_REQUEST_TIMEOUT_S)["tokens"]
            lone_s.append(time.perf_counter() - t0)
            if got != want:
                raise AssertionError(f"serve: lone request {i} ({len(p)} tokens) through the handle differs from the "
                                     f"engine phase's lone run: {_first_difference(got, want)}")
        log(f"serve: {len(lone_s)} lone requests through the handle equal the engine phase's lone tokens; "
            f"latency {[round(x, 3) for x in lone_s]} s")
        url = f"http://127.0.0.1:{serve.http_port()}/llm"
        t0 = time.perf_counter()
        got = _post_json(url, {"prompt": served["lone_prompts"][0], "max_new_tokens": n})["tokens"]
        http_s = time.perf_counter() - t0
        want = served["lone_tokens"][len(served["lone_prompts"])]
        if got != want:
            raise AssertionError(f"serve: the HTTP request differs from the engine phase's repeat of prompt 0: "
                                 f"{_first_difference(got, want)}")
        log(f"serve: HTTP POST {url} ({len(served['lone_prompts'][0])} tokens, {n} new): round trip {http_s:.3f} s, "
            f"tokens equal the engine phase's")
        t0 = time.perf_counter()
        burst = _stream_burst(handle, served["requests"], n)
        wall = time.perf_counter() - t0
        if any(len(t) != n for t, _, _ in burst):
            raise AssertionError(f"serve: burst requests unfinished: {[len(t) for t, _, _ in burst]}")
        same = sum(t == w for (t, _, _), w in zip(burst, served["tokens"]))
        ttft = sorted(f for _, f, _ in burst)
        tpot = sorted((total - f) / (n - 1) for _, f, total in burst)
        tok_s = len(burst) * n / wall
        log(f"serve: burst of {len(burst)} streamed requests ({n} new each): {tok_s:.1f} tokens/s through Serve "
            f"against the engine phase's {served['tokens_per_s']:.1f} in process; TTFT p50 "
            f"{ttft[len(ttft) // 2] * 1e3:.1f} ms, p99 {_p99(ttft) * 1e3:.1f} ms, TPOT p50 "
            f"{tpot[len(tpot) // 2] * 1e3:.2f} ms; {same} of {len(burst)} equal the in-process batched tokens "
            f"(not gated: batching by arrival changes bf16 rounding)")
        counts = tally("colocated", replica, cfg.n_layers)
        log(f"serve: colocated replica: {counts['forwards']} paged forwards, launches {counts['launches']}")
        serve.delete("llm")

        # 2. Disaggregated, f32 at the parity phase's model: exact against colocated.
        pcfg = CONFIGS[spec.model](**parity)
        if on_card:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        prompts = [served["requests"][0], served["requests"][1][:100]]
        colo = InferenceEngine(pcfg, None, EngineOptions(**parity_options, seed=0),
                               device="cuda" if on_card else spec.device)
        colo.start()
        try:
            want = [colo.generate(p, n) for p in prompts]
        finally:
            colo.shutdown()
        del colo
        if on_card:
            torch.cuda.empty_cache()
        _disagg(replica_cls, spec, parity, parity_options, "disagg32", prompts, want, n, tally, pcfg, exact=True)

        # 3. Disaggregated at full width: every full block imported.
        _disagg(replica_cls, spec, full, engine_options, "disagg", served["lone_prompts"],
                served["lone_tokens"], n, tally, cfg, exact=False)
    finally:
        left = _end_session(controller, session_dir, serve.shutdown)
    if left:
        raise AssertionError(f"serve: processes outlived shutdown (killed): {left}")
    launches["serve"] = serve_launches
    log(f"serve: launches in the replicas {serve_launches}")
    if on_card:
        deadline = time.monotonic() + 60
        while torch.cuda.mem_get_info()[0] < free_before - MEMORY_RELEASE_SLACK and time.monotonic() < deadline:
            time.sleep(0.5)
        free = torch.cuda.mem_get_info()[0]
        log(f"serve: card memory free after shutdown {free / 2**30:.2f} GiB (before the phase "
            f"{free_before / 2**30:.2f} GiB)")
        if free < free_before - MEMORY_RELEASE_SLACK:
            raise AssertionError(f"serve: the card's memory was not released: {free / 2**30:.2f} GiB free, "
                                 f"{free_before / 2**30:.2f} GiB before")


def _p99(sorted_values: list) -> float:
    return sorted_values[min(len(sorted_values) - 1, int(0.99 * len(sorted_values)))]


def _exact(what: str, got: list, want: list) -> None:
    if got != want:
        raise AssertionError(f"{what} differs from colocated decoding: {_first_difference(got, want)}")


def _disagg(replica_cls, spec: ServeSpec, overrides: dict, engine_options: dict, name: str, prompts: list,
            want: list, n: int, tally, cfg, exact: bool) -> None:
    """One prefill and one decode replica on half the card each. Every
    prompt goes through generate and then generate_stream (the handle runs
    the prefill -> export -> import -> decode handoff); the decode replica
    must have imported every full block of every prompt (an import that
    degrades to recompute fails), and with `exact` each result must equal
    `want` (colocated decoding), else the equal tokens are counted."""
    from ray_tpu_torch import serve

    t0 = time.perf_counter()
    handle = serve.run(_llm_app(replica_cls, spec.model, overrides, engine_options, spec.device,
                                num_replicas=2, prefill_replicas=1, max_ongoing_requests=64,
                                ray_actor_options={"num_gpus": 0.5, "max_concurrency": 16}),
                       name=name, route_prefix=f"/{name}", timeout_s=SERVE_BOOT_TIMEOUT_S)
    boot_s = time.perf_counter() - t0
    reps = _replicas(name)
    if sorted(role or "" for _, role in reps) != ["decode", "prefill"]:
        raise AssertionError(f"serve {name}: replica roles {[role for _, role in reps]}")
    for rep, _ in reps:
        _replica_call(rep, "smoke_counts", True)
    results = []
    for p in prompts:
        t0 = time.perf_counter()
        got = handle.generate.remote(p, n).result(timeout_s=SERVE_REQUEST_TIMEOUT_S)["tokens"]
        gen_s = time.perf_counter() - t0
        t0, first, streamed = time.perf_counter(), None, []
        for tok in handle.options(stream=True).generate_stream.remote(p, n):
            if first is None:
                first = time.perf_counter() - t0
            streamed.append(tok)
        results.append((got, streamed, gen_s, first))
    stats = {role: _replica_call(rep, "engine_stats") for rep, role in reps}
    counts = {role: tally(f"{name} {role}", rep, cfg.n_layers) for rep, role in reps}
    serve.delete(name)

    bs = engine_options["block_size"]
    full_blocks = [len(p) // bs for p in prompts]
    block_bytes = 2 * cfg.n_layers * cfg.n_heads * bs * cfg.d_head * cfg.dtype.itemsize
    imported, exported = stats["decode"]["blocks_imported"], stats["prefill"]["blocks_exported"]
    same = [sum(a == b for a, b in zip(got, w)) for (got, _, _, _), w in zip(results, want)]
    log(f"serve {name}: prefill + decode replica ({spec.model} {overrides}, num_gpus=0.5 each) booted in "
        f"{boot_s:.2f} s; {len(prompts)} prompts ({[len(p) for p in prompts]} tokens), generate then "
        f"generate_stream each: blocks exported {exported}, imported {imported} (full blocks "
        f"{sum(full_blocks)}); KV bytes exported per handoff {[b * block_bytes for b in full_blocks]}; "
        f"import ms per handoff {[round(x, 2) for x in counts['decode']['import_ms']]}; generate latency "
        f"{[round(r[2], 3) for r in results]} s; handoff TTFT (stream) {[round(r[3] * 1e3, 1) for r in results]} "
        f"ms; tokens equal to colocated {same} of {n} each")
    if imported < sum(full_blocks):
        raise AssertionError(f"serve {name}: the decode replica imported {imported} blocks, fewer than the prompts' "
                             f"{sum(full_blocks)} full blocks (a handoff degraded to recompute)")
    for i, (got, streamed, _, _) in enumerate(results):
        if len(got) != n or len(streamed) != n:
            raise AssertionError(f"serve {name}: request {i} returned {len(got)} / {len(streamed)} tokens, want {n}")
        if exact:
            _exact(f"serve {name}: request {i} (generate)", got, want[i])
            _exact(f"serve {name}: request {i} (generate_stream)", streamed, want[i])


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
    gpipe = None
    if "trainer" in phases:
        gpipe = phase_trainer(launches)
    if "mpmd" in phases:
        phase_mpmd(launches, gpipe)
    if "parallel" in phases:
        phase_parallel(launches)
    generated = served = None
    if "generate" in phases or "engine" in phases:
        cfg, params = _llama_params()
        if "generate" in phases:
            generated = phase_generate(cfg, params, launches)
        if "engine" in phases:
            served = phase_engine(cfg, params, launches)
        del params  # the runtime phase's actor loads its own copy
        torch.cuda.empty_cache()
    if "runtime" in phases:
        if generated is None:
            ap.error("the runtime phase holds its actor's tokens against the generate phase's: run both")
        log(f"driver device memory before the runtime phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            "allocated")
        phase_runtime(generated, launches)
    if "serve" in phases:
        if served is None:
            ap.error("the serve phase holds its replicas' tokens against the engine phase's: run both")
        phase_serve(served, launches)
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
             "shapes", "launch_floor_ms", "copy_ms",
             # the three flash kernels: their wide-head route (D > 256) at WIDE_ATTN
             "wide")
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys}, **{k: r[k] for k in extra if k in r}}
                                  for r in results.values()]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
  5. train_parity  llama-7b widths, 1 layer, f32, remat "attn": loss and
              every gradient on the card vs the CPU, then the params after
              2 AdamW steps
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
              the driver; and gpt2-large at 4 layers, B=4 x S=1024, 6
              steps with an elastic checkpoint every 2, its worker
              SIGKILLed after step 3: the gang restarts on a new worker
              from the step-2 commit and every loss equals the unkilled
              run's bit for bit (restart s, checkpoint MB, step ms with and
              without a save in flight)
  6c. mpmd    MPMD pipeline training on the copied runtime: MPMDTrainer gangs
              of GPU-worker stage actors (num_gpus 1/(S*dp) each), 1F1B over
              compiled-DAG edges with ZeRO updates: llama-7b widths (4
              layers, B=8 x S=512, M=4, 2 stages, dp=1; the trainer phase's
              GPipe cell) on 6 new batches, each step within 2e-2 of the
              plain step from the same params with the same AdamW, then 2
              steps on the first two again: its first loss within 2e-3 of
              loss_fn, falling by the last step, launches per step as
              predicted (step ms, tokens/s, busy and update s per stage,
              the bubble, edge bytes); the same run interleaved (v=2) with
              the v=1 losses; run_local_pipeline
              card vs CPU (llama-7b widths, 2 layers, f32); gpt2-large
              widths (2 layers, tied: the bridge runs) at dp=2, ZeRO, a
              checkpoint every 2 steps, a stage-1 replica SIGKILLed after
              step 3: the gang re-spawns, restores at the common commit and
              repeats an unkilled replicated run's losses bit for bit; ZeRO
              halves the optimizer bytes per replica (restart s, update s,
              bridge bytes)
  6d. data    the data plane and HF interop on the copied runtime: the
              trainer phase's gpt2-large step through
              TorchTrainer(datasets=), its batches streamed through
              session.get_streaming_ingest from a dataset whose rows the
              cluster's CPU tasks make, its losses and grad norms bit-equal
              to the driver's plain step on the same rows (tokens/s beside
              the in-process feed, ingest wait per step, seconds to the
              first batch, the ingest's stats); a GPT-2 state dict at
              gpt2-large widths, 24 layers (HF's names, seeded random), through
              config_from_hf -> params_from_hf -> TransformersTrainer: the
              round trip bit for bit, its first loss within 2e-3 of
              loss_fn, its losses bit-equal to the driver's run of the
              loop's step, its checkpoint exported with HF's keys and shapes
  6e. gbdt    the GBDT booster on the card: GradientBoostedTrees.fit on 500,000
              HIGGS-shaped rows (28 f32 features, seeded) at XGBoost's default
              params (depth 6, eta 0.3, 256 bins), 50 rounds, twice: the trees
              bit for bit equal, the train loss falling, the validation
              log-loss below the base rate's; the fit card vs CPU on 200,000
              rows, 10 rounds (every differing split a near-tie); and
              XGBoostTrainer(datasets={"train", "valid"}) on one GPU worker,
              its rows in order and its trees the in-process fit's (host
              binning s, card ms per round, the histogram's share,
              index_add_ against index_put_, peak memory, predict rows/s)
  6f. rllib   RLlib's core and PPO: PPO CartPole-v1 (BASELINE config #1, the
              learner and local runner on the card) to mean reward 150
              within 100,000 env steps; one PPO update card vs CPU (f32);
              two remote env runners (CPU actors) and a remote learner (a
              GPU worker), 3 iterations, the step count exact, save ->
              restore bit for bit; PPO Pendulum-v1 and MultiAgentPPO (two
              policies); the cnn encoder at 84x84x4, card vs CPU
  6f'. rllib_algos RLlib's discrete-action algorithms, the learner and local
              runner on the card: DQN, IMPALA, APPO, A2C, BC and MARWIL to
              their reference tests' bars within their iteration limits,
              from their seeds (iterations, env steps, sample and update
              ms, the DQN update's idle share); one update of each of the
              eight (Ape-X and CQL too) card vs CPU (f32); IMPALA's async
              path (2 CPU-actor runners, 5 iterations: the steps, the
              re-arming and the weight puts exact); Ape-X (2 runners, 2
              replay shards: sizes, one priority per sampled index); CQL, 3
              iterations on transition data
  6f''. rllib_algos_ii SAC, TD3 and DDPG on Pendulum-v1 and the Decision
              Transformer on CartPole-v1 (40 scripted-expert episodes), the
              learner and local runner on the card, to their reference
              tests' bars within their iteration limits, from their seeds;
              each Pendulum update's gradient steps replayed as CUDA graphs,
              held bit for bit against the same steps eager at the first
              update (ms a gradient step each way); one update of each of
              the four card vs CPU (f32, the same draws); iterations, env
              steps, sample and update ms, one update's idle share
  6f'''. rllib_dreamer DreamerV3 on CartPole-v1, the learner and local runner
              on the card: the reference's world-model smoke (6 iterations,
              4 gradient steps of 16 sequences: recon falls, losses finite),
              then mean reward 130 within 120 iterations at the defaults
              (seed 0); each gradient step (world model, imagination,
              behaviour, three Adams, EMA critic, return scale) and each
              acting step replayed as one CUDA graph, held bit for bit
              against the same steps eager at the first update; one update
              card vs CPU (f32, the same Gumbel noise); iterations, env
              steps, sample and update ms, one update's idle share
  6f''''. rllib_podracer the podracer planes through PPO's entry point:
              Anakin on the card (CartPole-v1, 64 envs x 32, batch 2048,
              minibatch 512, 4 epochs, lr 2.5e-3, seed 7) to the reference
              test's bar in 15 iterations, its rollout one CUDA graph held
              bit for bit against eager, one fused step card vs CPU (f32,
              the same draws), one profiled step (rollout and update ms,
              env steps/s, idle share) and one iteration at 4096 envs;
              Sebulba (2 CPU actors x 32 envs x 128, the learner in a GPU
              worker, seed 11): 2 iterations over the block transport
              (arena stats), a SIGKILLed actor survived inside one train()
              with the step count continuous, one more iteration, the
              learner's update card vs CPU (build, learner step ms,
              restart s)
  6g. parallel the mesh path on a one-rank NCCL world (make_mesh(), all six
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
import types

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PHASES = ("device", "build", "kernels", "parity", "train_parity", "train", "trainer", "mpmd", "data",
          "gbdt", "rllib", "rllib_algos", "rllib_algos_ii", "rllib_dreamer", "rllib_podracer", "parallel", "generate",
          "engine", "runtime", "serve")
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
    us = sum(end - start for _, start, end in device_events(prof, torch.autograd.DeviceType.CUDA))
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


# AdamW steps card vs CPU (3 until the rllib_algos_ii phase joined the
# script: its time limit; each CPU step ≈ 8-12 s).
TRAIN_PARITY_STEPS = 2


def phase_train_parity(launches: dict) -> None:
    """llama-7b widths, 1 layer, f32, TF32 off, remat "attn": one step's
    loss and every gradient on the card (kernels) against the CPU (plain),
    then the params after TRAIN_PARITY_STEPS AdamW steps (bench.py's
    hyperparameters)."""
    import torch

    from ray_tpu_torch.models.gpt import init_params, llama_7b, make_train_step
    from ray_tpu_torch.optim import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # 2 layers until the rllib_algos_ii phase joined the script (its time
    # limit: the CPU side's 3 steps took most of the phase's 48.9 s).
    cfg = llama_7b(n_layers=1, dtype=torch.float32, remat=True, remat_policy="attn")
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
    log(f"train_parity f32 llama-7b widths L={cfg.n_layers} B=2 S=128 remat=attn: loss gpu {m_gpu['loss'].item():.6f} "
        f"cpu {m_cpu['loss'].item():.6f} (rel diff {loss_d:.2e}); grads: worst max|d|/max|ref| "
        f"{worst:.2e} ({worst_name}); grad_norm gpu {m_gpu['grad_norm'].item():.6f} cpu "
        f"{m_cpu['grad_norm'].item():.6f}; one CPU step {t_cpu:.1f} s; launches in the step {first}")
    if loss_d > 1e-5 or worst > 1e-4:
        raise AssertionError(f"train_parity: loss rel diff {loss_d:.2e} (tol 1e-5) or grad {worst_name} "
                             f"rel diff {worst:.2e} (tol 1e-4)")
    for _ in range(TRAIN_PARITY_STEPS - 1):
        steps["cpu"](cpu, batches["cpu"])
        steps["gpu"](gpu, batches["gpu"])
    torch.cuda.synchronize()
    launches["train_parity"] = read_launches()
    upd = _update_rel_diff(gpu, cpu, start)
    max_d = max((gpu[k].detach().cpu() - cpu[k].detach()).abs().max().item() for k in cpu)
    log(f"train_parity after {TRAIN_PARITY_STEPS} AdamW steps: ||update gpu - update cpu|| / ||update cpu|| = "
        f"{upd:.2e}, max |param gpu - param cpu| = {max_d:.2e} (lr {hyper['lr']}); launches over the "
        f"{TRAIN_PARITY_STEPS} steps {launches['train_parity']}")
    if upd > 1e-3:
        raise AssertionError(f"train_parity: params after {TRAIN_PARITY_STEPS} steps differ by {upd:.2e} of the "
                             "update (tol 1e-3)")
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
    # 10 steps, killed after step 5, until the rllib_algos phase joined the
    # script (its time limit); still one step past the last commit.
    kill_steps: int = 6
    save_every: int = 2
    kill_after: int = 3
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


def _trainer_in_process(job: tuple, steps: int, device, seeds, warm: int = 0, feed=None):
    """The plain step (no mesh) in the driver from the trainer's seeds:
    (losses, grad norms, tokens/s over the steps after `warm`). `seeds`:
    (params seed, batch seed or None for one batch per step keyed 100 + s).
    With `feed` (step -> host [B, S+1] tokens) each step's batch is moved to
    the device inside the timed loop instead, as a data-plane loop does."""
    import torch

    from ray_tpu_torch.models.gpt import init_params, make_train_step
    from ray_tpu_torch.optim import AdamW

    cfg = _trainer_cfg(job)
    params = init_params(cfg, seed=seeds[0], device=device)
    step = make_train_step(cfg, AdamW(params.values(), **TRAINER_ADAMW, mu_dtype=torch.bfloat16))
    made = [] if feed else [_trainer_batch(cfg, job[2], seeds[1] if seeds[1] is not None else 100 + s, device)
                            for s in range(steps)]

    def batch(s):
        return {"tokens": torch.as_tensor(feed(s)).to(device)} if feed else made[s]

    losses, norms, t0 = [], [], None
    for s in range(steps):
        if s == warm:
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
        _, m = step(params, batch(s))
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
    ({"step_ms", "tokens_per_s"}: report to report, after the warm-up) and
    the in-process plain step's tokens/s (`in_process_tokens_per_s`)."""
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
                 "tokens_per_s": spec.pipe[2][0] * spec.pipe[2][1] * len(gaps) / sum(gaps),
                 "in_process_tokens_per_s": in_process_tok_s}
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
    # 8 timed steps (the pool's 2 batches seen twice) until the
    # rllib_algos_ii phase joined the script (its time limit).
    timed: int = 6
    # The 1F1B runs' batches: a new batch each of the first `fresh` steps,
    # then the first `pool` batches again in turn (`_mpmd_schedule`). On new
    # batches the loss does not fall in 6 steps at lr 3e-4 (llama-7b widths:
    # 11.17, 19.78 at step 3, 11.47 on an H100) and the plain step from the
    # same params does the same, so those steps are held to the plain step;
    # on the pool the loss falls as the model fits it, and the two part
    # (the plain step's losses 2.1257 -> 0.7848 over 4 pool steps, 1F1B's
    # 2.1251 -> 0.7647, 2.56e-02 apart at the fourth on an H100: bf16 sums
    # in another order, amplified as the model memorises two batches).
    # The pool and the new batches were two gangs until the rllib_algos
    # phase joined the script.
    fresh: int = 6
    pool: int = 2
    parity: tuple = ("llama-7b", {"n_layers": 2, "dtype": "float32"}, (2, 128))
    parity_micro: int = 2
    # 2 steps (the CPU side ≈ 20 s a step) until the rllib_algos_ii phase
    # joined the script (its time limit).
    parity_steps: int = 1
    # gpt2-large widths at 2 layers, one a stage, for 4 steps (4 layers and 6
    # steps until the gbdt and rllib phases joined the script): the kill
    # after step 3, the resume at the step-2 commit, steps 3 and 4 again.
    kill: tuple = ("gpt2-large", {"n_layers": 2}, (8, 1024))
    kill_micro: int = 2
    kill_dp: int = 2
    kill_steps: int = 4
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
    recomputes the RMSNorms but no flash forward, full remat reruns it too;
    every layer runs one dQ and one dK/dV; the last chunk adds the final
    RMSNorm. One stage, one chunk, one microbatch (S = v = M = dp = 1) is
    the plain `make_train_step`'s step."""
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
    skewed toward low ids (V·u³, u uniform). At lr 3e-4 from the 0.02 init
    the loss does not fall on a new batch every step within 6 steps, in the
    plain step as in the pipeline; it falls on a pool of a few batches."""
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
    threads = torch.get_num_threads()
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for name in ("cpu", "card"):
            dev = "cuda" if name == "card" and on_card else "cpu"
            # On the CPU the stages run on threads of their own: each gets its
            # share of the cores (at the full count each they oversubscribe them).
            torch.set_num_threads(max(1, threads // spec.stages) if dev == "cpu" else threads)
            t0 = time.perf_counter()
            with counted(counts) if name == "card" else contextlib.nullcontext({}) as run:
                res = run_local_pipeline(cfg, spec.stages, 1, M, batches, params=params, device=dev,
                                         **spec.adamw)
            out[name] = ([h["loss"] for h in res["history"]], [h["grad_norm"] for h in res["history"]],
                         time.perf_counter() - t0)
            del res
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_num_threads(threads)
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


def _mpmd_schedule(spec: MPMDSpec, s: int) -> int:
    """The offset from the run's batch seed of the batch 1F1B step s
    (0-based) takes: s for the first `spec.fresh` steps, then the pool's
    batches in turn."""
    return s if s < spec.fresh else (s - spec.fresh) % spec.pool


def _mpmd_plain(cfg, spec: MPMDSpec, seed: int, batch_seed: int, steps: int) -> list:
    """The plain step (`make_train_step`, no pipeline) in the driver from
    the MPMD run's params (`init_params(seed)` on the CPU) with its AdamW
    (`spec.adamw` and MPMDOptions' betas and eps, f32 moments), on the
    batches the MPMD run takes (`batch_seed + s`): its losses, step by
    step."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.optim import AdamW
    from ray_tpu_torch.train.mpmd import MPMDOptions

    o = MPMDOptions(**spec.adamw)
    dev = "cuda" if spec.device is None else spec.device
    params = {k: t.to(dev, copy=True) for k, t in gpt.init_params(cfg, seed=seed, device="cpu").items()}
    step = gpt.make_train_step(cfg, AdamW(params.values(), lr=o.lr, betas=o.betas, eps=o.eps,
                                          weight_decay=o.weight_decay))
    losses = []
    for s in range(steps):
        tokens = torch.as_tensor(_mpmd_batch(cfg, spec.pipe[2], batch_seed + s)).to(dev)
        losses.append(step(params, {"tokens": tokens})[1]["loss"].item())
    del params, step
    if spec.device is None:
        torch.cuda.empty_cache()
    return losses


def _mpmd_fit(cfg, spec: MPMDSpec, storage: str, name: str, job: tuple, seed: int, batch_seed: int,
              steps: int, batch_hook=None, holder: dict | None = None, scheduled: bool = False, **options):
    """One MPMDTrainer.fit() (a fresh gang of GPU-worker stage actors).
    Step s takes the batch of seed `batch_seed + s` (`scheduled`: of
    `batch_seed + _mpmd_schedule(spec, s)`, new batches and then a few seen
    again, so the loss falls as the model fits them); `batch_hook(step)`
    runs in the driver before each step's batch, and `holder["trainer"]` is
    the trainer while it runs."""
    from ray_tpu_torch.train import FailureConfig, RunConfig
    from ray_tpu_torch.train.mpmd import MPMDOptions, MPMDTrainer

    def batch_fn(step):
        if batch_hook is not None:
            batch_hook(step)
        return _mpmd_batch(cfg, job[2], batch_seed + (_mpmd_schedule(spec, step) if scheduled else step))

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
    GPipe cell) and its interleaved twin on new batches, held to the plain
    step from the same params with the same AdamW (2e-2 a step), and then
    on a pool of them seen again, the loss falling; the card-vs-CPU parity in the
    driver; gpt2-large widths at dp=2 (tied: the bridge runs) with a
    stage-1 replica SIGKILLed after the `kill_after` result, resumed at the
    common commit. Launches are counted in each actor, per step. The
    driver draws each set of CPU params once (`_cpu_params_drawn_once`)."""
    spec = spec or MPMDSpec()
    with _cpu_params_drawn_once():
        _phase_mpmd(launches, gpipe, spec)


@contextlib.contextmanager
def _cpu_params_drawn_once():
    """Within the block `gpt.init_params` on the CPU from an int seed draws
    each (config, seed, dtype) once and hands the same tensors to every
    call, bit for bit the params a fresh draw gives; no caller in the block
    changes them in place. A CPU draw is serial (≈9.8 s for llama-7b widths
    at 4 layers), and the mpmd phase draws the same params for its serial
    loss, its plain step and each of its gangs (`MPMDTrainer` seeds in the
    driver, and again at a re-spawn)."""
    import torch

    from ray_tpu_torch.models import gpt

    draw, cache = gpt.init_params, {}

    def init_params(cfg, seed=0, device=None, dtype=torch.float32):
        if isinstance(seed, int) and device is not None and torch.device(device).type == "cpu":
            key = (repr(cfg), seed, str(dtype))
            if key not in cache:
                cache[key] = draw(cfg, seed=seed, device=device, dtype=dtype)
            return dict(cache[key])
        return draw(cfg, seed=seed, device=device, dtype=dtype)

    gpt.init_params = init_params
    try:
        yield
    finally:
        gpt.init_params = draw


def _phase_mpmd(launches: dict, gpipe: dict | None, spec: MPMDSpec) -> None:
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train.elastic import latest_common_committed
    from ray_tpu_torch.train.mpmd import theoretical_bubble_fraction

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
    plain_losses = _mpmd_plain(cfg, spec, seed=7, batch_seed=100, steps=spec.fresh)
    free_before = torch.cuda.mem_get_info()[0] if on_card else None

    storage = tempfile.mkdtemp(prefix="rtput-mpmd-")
    t0 = time.perf_counter()
    rt.init(**spec.init)
    backend = api._global_runtime().backend
    session_dir, controller = backend.session_dir, backend._controller_proc.pid
    try:
        log(f"mpmd: cluster up in {time.perf_counter() - t0:.2f} s, resources {rt.cluster_resources()}")

        # 2. 1F1B and interleaved 1F1B at llama-7b widths, new batches and
        # then the pool's.
        runs = {}
        for name, chunks in (("v1", 1), (f"v{v}", v)):
            res = _mpmd_fit(cfg, spec, storage, f"pipe-{name}", spec.pipe, seed=7, batch_seed=100, steps=steps,
                            scheduled=True, dp=1, num_microbatches=M, num_chunks=chunks, zero=True,
                            num_gpus_per_replica=1.0 / S)
            runs[name] = res
            _wait_card_released(free_before, f"pipe {name}")
        B, Sq = spec.pipe[2]
        for name, res in runs.items():
            chunks = v if name == f"v{v}" else 1
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
            log(f"mpmd 1F1B {spec.pipe[0]} {spec.pipe[1]} B={B} S={Sq} M={M} stages={S} v={chunks} dp=1 ZeRO, "
                f"{spec.fresh} new batches, then the pool of {spec.pool}: loss "
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
        one = runs["v1"]["history"]
        rel = abs(one[0]["loss"] - serial) / abs(serial)
        log(f"mpmd 1F1B first loss {one[0]['loss']:.6f} vs loss_fn {serial:.6f} (rel diff {rel:.2e})")
        if rel > 2e-3 or not (math.isfinite(one[-1]["loss"]) and one[-1]["loss"] < one[0]["loss"]):
            raise AssertionError(f"mpmd 1F1B: first loss {rel:.2e} from loss_fn (tol 2e-3), or the loss "
                                 f"{one[0]['loss']} -> {one[-1]['loss']} is not finite and falling")
        l1, l2 = [h["loss"] for h in one], [h["loss"] for h in runs[f"v{v}"]["history"]]
        worst = max(abs(a - b) / abs(a) for a, b in zip(l1, l2))
        log(f"mpmd interleaved v={v} losses vs v=1: "
            f"{'bit for bit' if l1 == l2 else 'NOT bit-equal'} (worst rel diff {worst:.2e})")
        if worst > 1e-3 or len(l1) != len(l2):
            raise AssertionError(f"mpmd interleaved: losses {l2} vs v=1 {l1} (tol 1e-3)")
        fresh = l1[:spec.fresh]
        diffs = [abs(a - b) / abs(b) for a, b in zip(fresh, plain_losses)]
        log(f"mpmd 1F1B on its {spec.fresh} new batches vs the plain step (same params, batches and AdamW): losses "
            f"{[round(x, 6) for x in fresh]} vs {[round(x, 6) for x in plain_losses]}; rel diff by step "
            f"{[f'{d:.2e}' for d in diffs]}; then on the pool {[round(x, 6) for x in l1[spec.fresh:]]}")
        if len(fresh) != len(plain_losses) or max(diffs) > 2e-2:
            raise AssertionError(f"mpmd 1F1B on new batches: losses {fresh} vs the plain step's {plain_losses} "
                                 "(tol 2e-2 relative)")

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


# ------------------------------------------------------------------ data
DATA_SEED = 1000  # the feed's row r: default_rng(DATA_SEED + r)
# The feed's dataset holds this many times the rows its steps take, so the
# loop shuts the ingest down mid-epoch with its producer parked on a full
# queue. (The trainer's split runs the whole plan in the driver before the
# gang starts, so the executor itself overlaps no step.)
DATA_ROWS_FACTOR = 4
HF_SEED = 5  # the HF state dict's weights and its token rows
HF_LR = 5e-5  # TransformersTrainer's AdamW lr


@dataclasses.dataclass
class DataSpec:
    """What the data phase trains. `feed`: the trainer phase's gpt2-large
    job (model, overrides, (B, S)) through `TorchTrainer(datasets=)`, its
    batches streamed from `ray_tpu_torch.data.range(DATA_ROWS_FACTOR * B *
    (warm + timed), parallelism=parallelism).map_batches(fn)` (fn: row r's
    [S+1] tokens from `default_rng(DATA_SEED + r)`, made in the cluster's
    CPU tasks). `hf`: GPT2Config's fields of an HF GPT-2 state dict made by
    torch from `HF_SEED`, trained through `TransformersTrainer` for
    `hf_steps` steps of `hf_batch` rows out of `hf_rows` (int32 [S+1]).
    `device` None: the card; the CPU rehearsal
    (tests/test_torch_chip_smoke.py) passes tiny models on "cpu" and one
    torch thread (`threads`)."""

    feed: tuple = ("gpt2-large", {}, (13, 1024))
    warm: int = 2
    timed: int = 5
    parallelism: int = 8
    # gpt2-large's widths at 24 of its 36 layers (36 until the rllib_algos
    # phase joined the script, whose time limit it is; the fit's time is
    # the params through the object store, not steps): 2.15 GB of f32
    # params, still past the 2 GB a task message carries, which is why
    # TransformersTrainer.fit puts them in the store.
    hf: dict = dataclasses.field(default_factory=lambda: dict(
        n_embd=1280, n_layer=24, n_head=20, n_inner=5120, vocab_size=50257, n_positions=1024))
    hf_rows: int = 64
    hf_batch: int = 8
    hf_steps: int = 4
    init: dict = dataclasses.field(default_factory=lambda: {"log_to_driver": False})
    device: str | None = None
    threads: int | None = None


def _data_fn(seed: int, vocab: int, width: int):
    """The feed's map_batches fn (a closure, so cloudpickle ships it by
    value to the CPU workers): row r's `width` int64 tokens drawn from
    `np.random.default_rng(seed + r)`, beside its id."""

    def fn(batch):
        import numpy as np

        ids = batch["id"]
        tokens = [np.random.default_rng(seed + int(r)).integers(0, vocab, width) for r in ids]
        return {"id": ids, "tokens": np.stack(tokens) if tokens else np.zeros((0, width), np.int64)}

    return fn


def _data_loop():
    """The feed's train_loop_per_worker: the plain step (the trainer
    phase's in-process step) on batches taken through
    `session.get_streaming_ingest` and moved to the card one by one; every
    step reports its loss, grad norm, ingest wait, the row ids it took and
    the kernel launches it made (counts set to 0 just before the step and
    read just after). It stops after its steps, mid-epoch, and the `with`
    shuts the ingest down."""

    def loop(config):
        import time

        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.kernels.flash_bwd import flash_bwd_dkv, flash_bwd_dq
        from ray_tpu_torch.kernels.flash_fwd import flash_fwd
        from ray_tpu_torch.kernels.rmsnorm import rmsnorm_fwd
        from ray_tpu_torch.models import gpt
        from ray_tpu_torch.optim import AdamW
        from ray_tpu_torch.train import session
        from ray_tpu_torch.train import torch as tt

        t_loop = time.time()
        if config["threads"]:
            torch.set_num_threads(config["threads"])
        kernels = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv,
                   "rmsnorm": rmsnorm_fwd}
        dev = tt.get_device() if config["device"] is None else torch.device(config["device"])
        if config["device"] is None and dev.type != "cuda":
            raise RuntimeError("no CUDA device on the trainer's worker")

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize()

        cfg, (B, S) = config["feed"]
        params = gpt.init_params(cfg, seed=0, device=dev)
        step = gpt.make_train_step(cfg, AdamW(params.values(), **config["adamw"], mu_dtype=torch.bfloat16))
        n = config["warm"] + config["timed"]
        t0 = None
        with session.get_streaming_ingest("train", batch_size=B) as ing:
            t_open = time.time()
            for i in range(n):
                if i == config["warm"]:
                    sync()
                    t0 = time.perf_counter()
                tw = time.perf_counter()
                batch = ing.next_batch()
                wait_ms = (time.perf_counter() - tw) * 1e3
                t_batch = time.time()
                tokens = torch.as_tensor(batch["tokens"]).to(dev)
                for k in kernels.values():
                    k.launches = 0
                _, m = step(params, {"tokens": tokens})
                launches = {name: k.launches for name, k in kernels.items()}
                train.report({"job": "feed", "i": i, "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                              "wait_ms": wait_ms, "ids": batch["id"].tolist(), "launches": launches,
                              "t_batch": t_batch, "t_open": t_open, "t_loop": t_loop})
            sync()
            elapsed = time.perf_counter() - t0
            stats = ing.stats()
        train.report({"job": "feed_summary", "tokens_per_s": B * S * config["timed"] / elapsed, "stats": stats,
                      "device": str(dev)})

    return loop


def _hf_loop():
    """TransformersTrainer's own loop (`huggingface._default_train_loop`),
    each of its reports stamped with the time and the kernel launches since
    the one before (the counts are set to 0 just before the loop and at each
    report: a report follows each step). `config["threads"]`, when set,
    fixes the worker's torch threads (the CPU rehearsal)."""

    def loop(config):
        import time

        import torch

        from ray_tpu_torch.kernels.flash_bwd import flash_bwd_dkv, flash_bwd_dq
        from ray_tpu_torch.kernels.flash_fwd import flash_fwd
        from ray_tpu_torch.kernels.rmsnorm import rmsnorm_fwd
        from ray_tpu_torch.train import huggingface
        from ray_tpu_torch.train.session import get_session

        if config.get("threads"):
            torch.set_num_threads(config["threads"])
        kernels = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv,
                   "rmsnorm": rmsnorm_fwd}
        session = get_session()
        report = session.report

        def stamped(metrics, checkpoint=None):
            launches = {name: k.launches for name, k in kernels.items()}
            for k in kernels.values():
                k.launches = 0
            report({**metrics, "t": time.time(), "launches": launches}, checkpoint)

        session.report = stamped
        for k in kernels.values():
            k.launches = 0
        huggingface._default_train_loop(config)

    return loop


def _hf_state_dict(hf: dict, seed: int, device) -> dict:
    """An HF GPT-2 state dict (HF's names, Conv1D [in, out] layouts,
    lm_head tied to wte), normal(0, 0.02) weights and (1 + them) LayerNorm
    scales, drawn by torch on `device` from `seed` and returned on the CPU
    in f32."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    E, F, V, P = hf["n_embd"], hf["n_inner"], hf["vocab_size"], hf["n_positions"]

    def r(*shape, base=0.0):
        return (torch.randn(shape, generator=gen, device=device) * 0.02 + base).cpu()

    sd = {"transformer.wte.weight": r(V, E), "transformer.wpe.weight": r(P, E),
          "transformer.ln_f.weight": r(E, base=1.0), "transformer.ln_f.bias": r(E)}
    for i in range(hf["n_layer"]):
        h = f"transformer.h.{i}"
        sd.update({f"{h}.ln_1.weight": r(E, base=1.0), f"{h}.ln_1.bias": r(E),
                   f"{h}.attn.c_attn.weight": r(E, 3 * E), f"{h}.attn.c_attn.bias": r(3 * E),
                   f"{h}.attn.c_proj.weight": r(E, E), f"{h}.attn.c_proj.bias": r(E),
                   f"{h}.ln_2.weight": r(E, base=1.0), f"{h}.ln_2.bias": r(E),
                   f"{h}.mlp.c_fc.weight": r(E, F), f"{h}.mlp.c_fc.bias": r(F),
                   f"{h}.mlp.c_proj.weight": r(F, E), f"{h}.mlp.c_proj.bias": r(E)})
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def _hf_in_process(params: dict, cfg, rows, spec: DataSpec, device):
    """In the driver, the HF loop's step (`make_train_step` with
    `AdamW(lr, weight_decay=0.01)`, the loop's default) on the loop's
    batches (rows in order, `hf_batch` at a time): the first batch's
    `loss_fn`, the losses, tokens/s after the first step."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.optim import AdamW

    p = {k: torch.tensor(v, device=device) for k, v in params.items()}
    b = spec.hf_batch
    batches = [torch.as_tensor(rows[i * b:(i + 1) * b]).to(device) for i in range(spec.hf_steps)]
    with torch.no_grad():
        first = gpt.loss_fn(p, {"tokens": batches[0]}, cfg).item()
    step = gpt.make_train_step(cfg, AdamW(p.values(), lr=HF_LR, weight_decay=0.01))
    losses, t0 = [], None
    for i, tokens in enumerate(batches):
        losses.append(step(p, {"tokens": tokens})[1]["loss"].item())
        if i == 0:
            t0 = time.perf_counter()
    tok_s = b * (rows.shape[1] - 1) * (spec.hf_steps - 1) / (time.perf_counter() - t0)
    del p, step, batches
    if device != "cpu":
        torch.cuda.empty_cache()
    return first, losses, tok_s


def phase_data(launches: dict, trainer: dict | None = None, spec: DataSpec | None = None) -> None:
    """The data plane and HF interop feeding gpt2-large training on the
    copied runtime (`ray_tpu_torch.init()` in cluster mode, one GPU worker
    per trainer). The feed cell: the trainer phase's step through
    `TorchTrainer(datasets={"train": ds})`, batches through
    `session.get_streaming_ingest`, its rows made by the cluster's CPU
    tasks; its losses and grad norms bit-equal to the driver's plain step
    on the same rows in the same order. The HF cell: a GPT-2 state dict at
    gpt2-large widths through `config_from_hf` -> `params_from_hf` ->
    `TransformersTrainer` (its own loop); the round trip bit for bit, its
    first loss within 2e-3 of `loss_fn`, its losses bit-equal to the
    driver's run of the loop's step, and its checkpoint exported with HF's
    keys and shapes. `trainer`: the trainer phase's return, for its
    in-process tokens/s."""
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.core import api
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.huggingface import (
        TransformersTrainer,
        config_from_hf,
        params_from_hf,
        params_to_hf_state_dict,
    )

    spec = spec or DataSpec()
    on_card = spec.device is None
    device = "cuda" if on_card else spec.device
    t_phase = time.perf_counter()
    if spec.threads:
        torch.set_num_threads(spec.threads)

    # 1. The driver's own runs first, each freed before the next.
    cfg = _trainer_cfg(spec.feed)
    B, S = spec.feed[2]
    n = spec.warm + spec.timed
    fn = _data_fn(DATA_SEED, cfg.vocab_size, S + 1)
    order = [list(range(i * B, (i + 1) * B)) for i in range(n)]  # preserve_order: the rows in order
    want_loss, want_norm, in_process_tok_s = _trainer_in_process(
        spec.feed, n, device, (0, None), warm=spec.warm, feed=lambda s: fn({"id": np.asarray(order[s])})["tokens"])

    hf_cfg = types.SimpleNamespace(**spec.hf)
    t0 = time.perf_counter()
    sd = _hf_state_dict(spec.hf, HF_SEED, device)
    hcfg = config_from_hf(hf_cfg)
    params, _ = params_from_hf(sd, hcfg)
    back = params_to_hf_state_dict(params, hcfg, hf_vocab_size=hf_cfg.vocab_size)
    exact = set(back) == set(sd) and all(back[k].dtype == v.dtype and torch.equal(back[k], v) for k, v in sd.items())
    n_params = sum(v.numel() for k, v in sd.items() if k != "lm_head.weight")
    n_bytes = sum(v.nbytes for v in params.values())
    log(f"data hf: state dict of {n_params / 1e6:.1f} M params ({len(sd)} tensors) -> config_from_hf -> "
        f"params_from_hf -> params_to_hf_state_dict: {'bit for bit' if exact else 'NOT equal'} "
        f"({time.perf_counter() - t0:.1f} s); {n_bytes / 1e9:.3f} GB of params for the object store")
    if not exact:
        raise AssertionError("data hf: params_to_hf_state_dict(params_from_hf(sd)) differs from sd")
    del back
    rows = np.random.default_rng(HF_SEED).integers(0, hf_cfg.vocab_size, (spec.hf_rows, hcfg.max_seq + 1)) \
        .astype(np.int32)
    hf_first, hf_want, hf_in_process_tok_s = _hf_in_process(params, hcfg, rows, spec, device)

    storage = tempfile.mkdtemp(prefix="rtput-data-")
    t0 = time.perf_counter()
    rt.init(**spec.init)
    backend = api._global_runtime().backend
    session_dir, controller = backend.session_dir, backend._controller_proc.pid
    feed_counts: dict = {}
    hf_counts: dict = {}
    try:
        log(f"data: cluster up in {time.perf_counter() - t0:.2f} s, resources {rt.cluster_resources()}")

        # 2. The feed cell.
        rows_total = DATA_ROWS_FACTOR * B * n
        ds = data.range(rows_total, parallelism=spec.parallelism).map_batches(fn)
        config = {"feed": (cfg, (B, S)), "warm": spec.warm, "timed": spec.timed, "adamw": TRAINER_ADAMW,
                  "device": spec.device, "threads": spec.threads}
        t_fit = time.time()
        result = TorchTrainer(_data_loop(), train_loop_config=config, datasets={"train": ds},
                              scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                              run_config=RunConfig(storage_path=storage, name="feed")).fit()
        fit_s = time.time() - t_fit
        if result.error:
            raise AssertionError(f"data feed: the run failed: {result.error}")
        steps = [m for m in result.metrics_history if m["job"] == "feed"]
        summary = next(m for m in result.metrics_history if m["job"] == "feed_summary")
        _sum_launches(feed_counts, steps)
        if [m["ids"] for m in steps] != order:
            raise AssertionError(f"data feed: rows taken {[m['ids'][:3] for m in steps]}..., want {order}")
        _check_equal("feed losses", [m["loss"] for m in steps], want_loss)
        _check_equal("feed grad norms", [m["grad_norm"] for m in steps], want_norm)
        waits = sorted(m["wait_ms"] for m in steps)
        want_launches = mpmd_launches(cfg, 1, 1, 1, 1)
        stats = summary["stats"]
        log(f"data feed {spec.feed[0]} B={B} S={S} on {summary['device']}: {rows_total} rows in "
            f"{spec.parallelism} blocks, {n} steps ({spec.warm} warm-up) took rows {order[0][0]}..{order[-1][-1]} in "
            f"order; losses and grad norms equal the in-process plain step's bit for bit ({want_loss[0]:.6f} -> "
            f"{want_loss[-1]:.6f}); {summary['tokens_per_s']:.1f} tokens/s through the data plane, "
            f"{in_process_tok_s:.1f} in process here ({summary['tokens_per_s'] / in_process_tok_s:.3f}x)"
            + (f", the trainer phase's in-process step {trainer['in_process_tokens_per_s']:.1f}" if trainer else "")
            + f"; ingest wait per step p50 {waits[len(waits) // 2]:.3f} ms, max {waits[-1]:.3f} ms (by step "
            f"{[round(m['wait_ms'], 3) for m in steps]}); first batch {steps[0]['t_batch'] - t_fit:.2f} s after fit() "
            f"({steps[0]['t_batch'] - steps[0]['t_open']:.3f} s after the ingest opened, worker loop began "
            f"{steps[0]['t_loop'] - t_fit:.2f} s after fit()); fit() {fit_s:.1f} s; StreamingIngest.stats() {stats}; "
            f"launches per step {steps[-1]['launches']} (predicted {want_launches}; the trainer phase's "
            f"36 / 36 / 36 / 0)")
        if on_card and any(m["launches"] != want_launches for m in steps):
            raise AssertionError(f"data feed: launches per step {[m['launches'] for m in steps]}, predicted "
                                 f"{want_launches}")

        # 3. The HF cell.
        t_fit = time.perf_counter()
        result = TransformersTrainer(
            model=(params, hcfg), datasets={"train": data.from_numpy(rows, column="tokens")},
            train_loop_config={"steps": spec.hf_steps, "batch_size": spec.hf_batch, "lr": HF_LR,
                               "device": spec.device, "threads": spec.threads},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(storage_path=storage, name="hf"), train_loop_per_worker=_hf_loop()).fit()
        hf_fit_s = time.perf_counter() - t_fit
        if result.error:
            raise AssertionError(f"data hf: the run failed: {result.error}")
        hist = result.metrics_history
        steps = [m for m in hist if not m.get("done")]
        _sum_launches(hf_counts, hist)
        got = [m["loss"] for m in steps]
        rel = abs(got[0] - hf_first) / abs(hf_first)
        _check_equal("hf losses", got, hf_want)
        final = result.checkpoint.to_dict()
        exported = params_to_hf_state_dict(final["params"], hcfg, hf_vocab_size=hf_cfg.vocab_size)
        shapes_ok = {k: tuple(v.shape) for k, v in exported.items()} == {k: tuple(v.shape) for k, v in sd.items()}
        moved = [k for k, v in exported.items() if not torch.equal(v, sd[k])]
        gaps = [b["t"] - a["t"] for a, b in zip(steps, steps[1:])]
        hf_tok_s = spec.hf_batch * hcfg.max_seq * len(gaps) / sum(gaps) if gaps else float("nan")
        want_launches = mpmd_launches(hcfg, 1, 1, 1, 1)
        log(f"data hf gpt2 {spec.hf} -> {hcfg.vocab_size}-row vocab, {hcfg.dtype}, remat {hcfg.remat} policy "
            f"{hcfg.remat_policy}, attn {hcfg.attn_impl}: TransformersTrainer fit() {hf_fit_s:.1f} s; losses "
            f"{[round(x, 6) for x in got]} equal the in-process run of the loop's step bit for bit; first loss "
            f"{got[0]:.6f} vs loss_fn {hf_first:.6f} (rel diff {rel:.2e}); {hf_tok_s:.1f} tokens/s (report to "
            f"report after the first step), {hf_in_process_tok_s:.1f} in process; checkpoint exports "
            f"{len(exported)} tensors with HF's keys and shapes: {shapes_ok}, {len(moved)} of them moved by "
            f"training; launches per step {[m['launches'] for m in steps]} (predicted {want_launches})")
        if rel > 2e-3 or not shapes_ok or not moved or not final.get("hf_state_dict_ready"):
            raise AssertionError(f"data hf: first loss {rel:.2e} from loss_fn (tol 2e-3), export shapes equal "
                                 f"{shapes_ok}, tensors moved {len(moved)}")
        if on_card and any(m["launches"] != want_launches for m in steps):
            raise AssertionError(f"data hf: launches per step {[m['launches'] for m in steps]}, predicted "
                                 f"{want_launches}")
        del final, exported
    finally:
        left = _end_session(controller, session_dir)
        shutil.rmtree(storage, ignore_errors=True)
    if left:
        raise AssertionError(f"data: processes outlived shutdown (killed): {left}")
    launches["data"], launches["hf"] = feed_counts, hf_counts
    log(f"data launches: feed {feed_counts}, hf {hf_counts}; phase wall {time.perf_counter() - t_phase:.1f} s")
    for path, counts in (("feed", feed_counts), ("hf", hf_counts)):
        if on_card and not all(counts.get(k, 0) > 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
            raise AssertionError(f"data {path}: a flash kernel of the path was not launched: {counts}")


# ------------------------------------------------------------------ gbdt
GBDT_SEED = 12  # the HIGGS-shaped rows: default_rng(GBDT_SEED)
GBDT_FEATURES = 28  # UCI HIGGS: 21 low-level + 7 high-level kinematic features
# XGBoost's defaults (max_depth 6, eta 0.3, max_bin 256, lambda 1,
# min_child_weight 1, gamma 0), binary:logistic, through XGBoostTrainer's map.
GBDT_XGB_PARAMS = {"objective": "binary:logistic", "eta": 0.3, "max_depth": 6, "max_bin": 256, "lambda": 1.0,
                   "min_child_weight": 1.0, "gamma": 0.0}
GBDT_TIE_TOL = 1e-5  # near-tie: f64 gains within this share of the node's gain terms
GBDT_PREDICT_TOL = 1e-5  # card vs CPU margins, |d| <= tol·(1 + |cpu|), when every split agrees


@dataclasses.dataclass
class GBDTSpec:
    """What the gbdt phase fits: `rows` HIGGS-shaped training rows (cut
    from HIGGS's 11,000,000: the host binning, the reference's numpy,
    grows linearly with the rows) and `valid_rows` validation rows, 28 f32
    features and a binary label from `default_rng(GBDT_SEED)`; `rounds`
    rounds of XGBoost's default params; the card-vs-CPU fit on the first
    `parity_rows` rows for `parity_rounds` rounds; the trainer's datasets in
    blocks of `block_rows`. `device` None: the card; the CPU rehearsal
    (tests/test_torch_chip_smoke.py) passes a tiny size on "cpu"."""

    # 2,000,000 until the rllib_algos_ii phase joined the script, 1,000,000
    # (500,000 to validate) until the rllib_podracer phase did (its time
    # limit: the host binning grows linearly with the rows).
    rows: int = 500_000
    valid_rows: int = 250_000
    rounds: int = 50
    parity_rows: int = 200_000
    parity_rounds: int = 10
    block_rows: int = 100_000
    init: dict = dataclasses.field(default_factory=lambda: {"log_to_driver": False})
    device: str | None = None


def higgs_like(n: int, seed: int):
    """[n, 28] f32 features shaped like HIGGS's (14 signed normal, 14
    positive and skewed like its momenta and masses) and a binary label from
    a nonlinear rule plus noise (about half positive), from
    `default_rng(seed)`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = np.empty((n, GBDT_FEATURES), np.float32)
    X[:, :14] = rng.standard_normal((n, 14), dtype=np.float32)
    X[:, 14:] = rng.lognormal(0.0, 0.5, (n, 14)).astype(np.float32)
    logit = (1.2 * X[:, 0] * X[:, 1] + np.sin(2.0 * X[:, 2]) + 0.8 * (X[:, 14] > 1.2) - 0.6 * X[:, 3] ** 2
             + 0.5 * np.log(X[:, 15]) * X[:, 4] + 0.4 * X[:, 16] - 0.2)
    y = (logit + rng.logistic(0.0, 1.0, n) > 0).astype(np.float32)
    return X, y


def _logloss(p, y) -> float:
    import numpy as np

    return float(-np.mean(y * np.log(p + 1e-9) + (1 - y) * np.log(1 - p + 1e-9)))


def _reachable(is_leaf):
    """[..., nodes] mask of the nodes a sample can land in or pass."""
    import numpy as np

    out = np.zeros_like(is_leaf)
    out[..., 0] = True
    for n in range(is_leaf.shape[-1]):
        for c in (2 * n + 1, 2 * n + 2):
            if c < is_leaf.shape[-1]:
                out[..., c] = out[..., n] & ~is_leaf[..., n]
    return out


def _split_differences(a: dict, b: dict) -> list:
    """(round, node) of every reachable node whose split (or leaf mark)
    differs between two fits' trees."""
    import numpy as np

    at = _reachable(a["is_leaf"]) | _reachable(b["is_leaf"])
    differ = at & ((a["feat"] != b["feat"]) | (a["thresh"] != b["thresh"]) | (a["is_leaf"] != b["is_leaf"]))
    return [tuple(int(i) for i in ix) for ix in np.argwhere(differ)]


def _near_tie(X, y, trees_a: dict, trees_b: dict, model_cpu, rnd: int, node: int, p) -> tuple:
    """At the first round where two fits differ, the f64 gains of each
    fit's split at `node` (whose ancestors both fits share), over the rows
    that reach it, from the gradients entering that round (the CPU fit's
    predictions of its first `rnd` trees). Returns (gap, scale): a near-tie
    when gap <= GBDT_TIE_TOL * scale, scale = (Σ|g|)² / (H + λ), the size of
    the f32 rounding in the gain's terms."""
    import numpy as np

    from ray_tpu_torch.models import gbdt

    head = gbdt.GradientBoostedTrees.from_dict(
        {**model_cpu.to_dict(), "trees": {k: v[:rnd] for k, v in model_cpu.trees.items()}}, device="cpu")
    pred = head.predict_raw(X).astype(np.float64)
    prob = 1 / (1 + np.exp(-pred))
    g, h = prob - y, prob * (1 - prob)
    bins = gbdt.apply_bins(X, model_cpu.edges)
    t = {k: v[rnd] for k, v in trees_a.items()}
    idx = np.zeros(len(y), np.int64)
    path = []
    n = node
    while n:
        path.append(n)
        n = (n - 1) // 2
    for child in reversed(path):  # route through the shared ancestors
        parent = (child - 1) // 2
        go_left = bins[np.arange(len(y)), t["feat"][parent]] <= t["thresh"][parent]
        keep = (idx == parent)
        idx = np.where(keep, np.where(go_left, 2 * parent + 1, 2 * parent + 2), idx)
    at = idx == node
    gg, hh, bb = g[at], h[at], bins[at]
    G, H = gg.sum(), hh.sum()

    def gain(trees):
        f, b = trees["feat"][rnd][node], trees["thresh"][rnd][node]
        if trees["is_leaf"][rnd][node]:
            return 0.0
        left = bb[:, f] <= b
        GL, HL = gg[left].sum(), hh[left].sum()
        return 0.5 * (GL**2 / (HL + p.reg_lambda) + (G - GL)**2 / (H - HL + p.reg_lambda)
                      - G**2 / (H + p.reg_lambda)) - p.gamma

    return abs(gain(trees_a) - gain(trees_b)), np.abs(gg).sum()**2 / (H + p.reg_lambda)


def _first_round_ties(X, y, diffs: list, trees: dict, model_cpu, p) -> list:
    """(node, gap, scale) of each differing split of the first round where
    two fits differ whose ancestors agree (below a differing split the rows
    differ, and so does everything after that round)."""
    if not diffs:
        return []
    first = diffs[0][0]
    nodes = {n for r, n in diffs if r == first}

    def ancestors(n):
        while n:
            n = (n - 1) // 2
            yield n

    return [(n, *_near_tie(X, y, trees, model_cpu.trees, model_cpu, first, n, p))
            for n in sorted(nodes) if not any(a in nodes for a in ancestors(n))]


def _gbdt_loop_counted():
    """The GBDT trainer's own loop (`gbdt_trainer._gbdt_loop`), its report
    stamped with the kernel launches since the loop began and a digest of
    the (X, y) it materialised from its shards, in order."""

    def loop(config):
        import hashlib

        import numpy as np

        from ray_tpu_torch.kernels.flash_bwd import flash_bwd_dkv, flash_bwd_dq
        from ray_tpu_torch.kernels.flash_fwd import flash_fwd
        from ray_tpu_torch.kernels.rmsnorm import rmsnorm_fwd
        from ray_tpu_torch.train import gbdt_trainer
        from ray_tpu_torch.train.session import get_session

        kernels = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv,
                   "rmsnorm": rmsnorm_fwd}
        digests = []
        materialize = gbdt_trainer._materialize_xy

        def digested(shard, label_column):
            X, y = materialize(shard, label_column)
            digests.append(hashlib.sha256(np.ascontiguousarray(X).tobytes() + y.tobytes()).hexdigest())
            return X, y

        session = get_session()
        report = session.report

        def stamped(metrics, checkpoint=None):
            launches = {name: k.launches for name, k in kernels.items()}
            report({**metrics, "launches": launches, "digests": list(digests)}, checkpoint)

        session.report = stamped
        gbdt_trainer._materialize_xy = digested
        for k in kernels.values():
            k.launches = 0
        try:
            gbdt_trainer._gbdt_loop(config)
        finally:
            gbdt_trainer._materialize_xy = materialize

    return loop


GBDT_PROBE_RUNS = 10


def _hist_probe(bins, g, h, n_bins: int, on_card: bool) -> dict:
    """The first level's histogram (every row in one node: the most rows
    per bin, so the most contention) by `index_add_` and by the booster's
    `index_put_(accumulate=True)`: each run GBDT_PROBE_RUNS times and
    compared bit for bit across the runs and with the CPU's serial sum in
    row order; each timed (CUDA events)."""
    import torch

    from ray_tpu_torch.models import gbdt

    N, F = bins.shape
    seg = torch.arange(F, device=bins.device)[None, :] * n_bins + bins
    num_seg = F * n_bins

    def index_add():
        vals = torch.stack([g, h], dim=1)[:, None, :].expand(N, F, 2).reshape(N * F, 2)
        out = torch.zeros((num_seg, 2), dtype=g.dtype, device=g.device)
        out.index_add_(0, seg.reshape(-1), vals)
        return out[:, 0], out[:, 1]

    def index_put():
        return gbdt._histograms(seg, g, h, num_seg)

    serial = gbdt._histograms(seg.cpu(), g.cpu(), h.cpu(), num_seg)  # the CPU's row-order sums
    out = {}
    for name, fn in (("index_add_", index_add), ("index_put_", index_put)):
        runs = [fn() for _ in range(GBDT_PROBE_RUNS)]
        same = all(torch.equal(r[0], runs[0][0]) and torch.equal(r[1], runs[0][1]) for r in runs)
        in_order = torch.equal(runs[0][0].cpu(), serial[0]) and torch.equal(runs[0][1].cpu(), serial[1])
        ms = cuda_ms(fn, iters=5, graph=False)[1] if on_card else float("nan")
        out[name] = {"deterministic": same, "row_order": in_order, "ms": ms}
    return out


def phase_gbdt(launches: dict, spec: GBDTSpec | None = None) -> None:
    """The GBDT booster on the card through its entry points:
    `GradientBoostedTrees.fit` on HIGGS-shaped rows at XGBoost's default
    params, twice (the trees bit for bit equal: the histogram's scatter-add
    is deterministic), its train loss falling and its validation log-loss
    below the base rate's; the same fit card vs CPU on a slice (every
    differing split a near-tie, the margins within GBDT_PREDICT_TOL when
    none differs); and `XGBoostTrainer(datasets={"train", "valid"})` on one
    GPU worker, its rows in the in-process order and its trees equal to the
    in-process fit's. Records the host binning, the card's time per round
    and the histogram's share of it, index_add_ against index_put_, peak
    device memory and prediction rows/s."""
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.core import api
    from ray_tpu_torch.models import gbdt
    from ray_tpu_torch.train import RunConfig, ScalingConfig, XGBoostTrainer

    spec = spec or GBDTSpec()
    on_card = spec.device is None
    device = "cuda" if on_card else spec.device
    t_phase = time.perf_counter()
    counts: dict = {}

    X, y = higgs_like(spec.rows + spec.valid_rows, GBDT_SEED)
    Xv, yv = X[spec.rows:], y[spec.rows:]
    X, y = X[:spec.rows], y[:spec.rows]
    p = XGBoostTrainer(datasets={}, label_column="y", params=dict(GBDT_XGB_PARAMS),
                       num_boost_round=spec.rounds).train_loop_config["gbdt_params"]
    log(f"gbdt: {spec.rows} + {spec.valid_rows} HIGGS-shaped rows x {GBDT_FEATURES} f32 (positives "
        f"{y.mean():.4f}); params from XGBoostTrainer's map {p}")

    # 1. In process, twice; the first fit's host binning timed inside it
    # (fit() calls the module's quantile_bins and apply_bins).
    binned: dict = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = binned[name] = fn(*args, **kwargs)
            binned[name + "_s"] = time.perf_counter() - t0
            return out
        return wrapper

    fits, fit_s = [], []
    for i in range(2):
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        stock = gbdt.quantile_bins, gbdt.apply_bins
        if i == 0:
            gbdt.quantile_bins, gbdt.apply_bins = timed("edges", stock[0]), timed("bins", stock[1])
        t0 = time.perf_counter()
        try:
            with counted(counts):
                fits.append(gbdt.GradientBoostedTrees(p, device=spec.device).fit(X, y))
        finally:
            gbdt.quantile_bins, gbdt.apply_bins = stock
        fit_s.append(time.perf_counter() - t0)
    host_bins, binning_s = binned["bins"], binned["edges_s"] + binned["bins_s"]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    model = fits[0]
    same = all(np.array_equal(fits[0].trees[k], fits[1].trees[k]) for k in model.trees) and \
        fits[0].train_history == fits[1].train_history
    t0 = time.perf_counter()
    with counted(counts):
        pv = model.predict(Xv)
    predict_s = time.perf_counter() - t0
    base = float(y.mean())
    base_ll = _logloss(np.full_like(yv, base), yv)
    valid_ll = _logloss(pv, yv)
    hist = model.train_history

    # The card's time per round and the histogram's share of it, on the
    # fit's own binned rows and gradients (one round: gradients, tree,
    # prediction, as fit() runs it).
    bins = torch.from_numpy(host_bins).to(device).long()
    yt = torch.as_tensor(y, device=device)
    pred = torch.full((spec.rows,), p.base_score, dtype=torch.float32, device=device)

    def one_round():
        g, h = gbdt._grad_hess(p.objective, pred, yt)
        t = gbdt._grow_tree(bins, g, h, p.max_depth, p.max_bins, p.reg_lambda, p.gamma, p.min_child_weight)
        return pred + p.learning_rate * gbdt._predict_tree(bins, *t, p.max_depth)

    round_ms = hist_share = float("nan")
    probe = {}
    with counted(counts):
        if on_card:
            round_ms = cuda_ms(one_round, iters=3, graph=False)[1]
            hist_share = _gbdt_hist_share(one_round)
        g0, h0 = gbdt._grad_hess(p.objective, pred, yt)
        probe = _hist_probe(bins, g0, h0, p.max_bins, on_card)
    del bins, yt, pred, g0, h0
    log(f"gbdt in process on {device}: host binning {binning_s:.2f} s ({spec.rows} x {GBDT_FEATURES}, numpy); "
        f"fit() {fit_s[0]:.2f} s, {fit_s[1]:.2f} s ({spec.rounds} rounds, depth {p.max_depth}, {p.max_bins} bins, "
        f"binning included); one round {round_ms:.3f} ms on the card (CUDA events, mean of 3), the histogram "
        f"{hist_share:.3f} of its device time (profiler); two fits {'bit for bit equal' if same else 'DIFFER'}; "
        f"train loss {hist[0]:.6f} -> {hist[-1]:.6f} ({len(hist)} evals); valid log-loss {valid_ll:.6f} vs the "
        f"base rate's {base_ll:.6f}, accuracy {((pv > 0.5) == yv).mean():.4f}; peak device memory "
        f"{peak / 2**30:.3f} GiB; predict() {spec.valid_rows / predict_s:.1f} rows/s ({predict_s:.3f} s for "
        f"{spec.valid_rows} rows, binning included)")
    log(f"gbdt level-0 histogram ({spec.rows} rows x {GBDT_FEATURES} features, {p.max_bins} bins): "
        + "; ".join(f"{k} {v['ms']:.3f} ms, {GBDT_PROBE_RUNS} runs "
                    f"{'bit for bit equal' if v['deterministic'] else 'DIFFER'}, "
                    f"{'equal to' if v['row_order'] else 'not'} the CPU's row-order sums"
                    for k, v in probe.items()))
    if not same:
        raise AssertionError("gbdt: two fits of the same rows on the same device gave different trees")
    if not probe["index_put_"]["deterministic"]:
        raise AssertionError("gbdt: the booster's index_put_ histogram differs between two runs")
    if not (hist[-1] < hist[0] and math.isfinite(hist[-1])):
        raise AssertionError(f"gbdt: the train loss did not fall: {hist}")
    if not valid_ll < base_ll:
        raise AssertionError(f"gbdt: valid log-loss {valid_ll} not below the base rate's {base_ll}")

    # 2. Card vs CPU on a slice.
    Xs, ys = X[:spec.parity_rows], y[:spec.parity_rows]
    ps = dataclasses.replace(p, num_boost_round=spec.parity_rounds)
    with counted(counts):
        on_dev = gbdt.GradientBoostedTrees(ps, device=spec.device).fit(Xs, ys)
    on_cpu = gbdt.GradientBoostedTrees(ps, device="cpu").fit(Xs, ys)
    diffs = _split_differences(on_dev.trees, on_cpu.trees)
    with counted(counts):
        m_dev = on_dev.predict_raw(Xv)
    m_cpu = on_cpu.predict_raw(Xv)
    err = float(np.max(np.abs(m_dev - m_cpu) / (1 + np.abs(m_cpu))))
    leaf_err = float(np.max(np.abs(on_dev.trees["leaf"] - on_cpu.trees["leaf"])))
    ties = _first_round_ties(Xs, ys, diffs, on_dev.trees, on_cpu, ps)
    ll_dev, ll_cpu = _logloss(1 / (1 + np.exp(-m_dev)), yv), _logloss(1 / (1 + np.exp(-m_cpu)), yv)
    log(f"gbdt card vs CPU ({spec.parity_rows} rows, {spec.parity_rounds} rounds): {len(diffs)} differing splits "
        f"{diffs[:8]}; margins max |d|/(1+|cpu|) {err:.3e} (tol {GBDT_PREDICT_TOL} when no split differs), leaf "
        f"values max |d| {leaf_err:.3e}, train histories {on_dev.train_history} vs {on_cpu.train_history}; "
        f"valid log-loss {ll_dev:.6f} vs {ll_cpu:.6f}; first differing round's splits (node, f64 gain gap, scale): "
        f"{[(n, f'{gap:.3e}', f'{sc:.3e}') for n, gap, sc in ties]}")
    if not diffs and err > GBDT_PREDICT_TOL:
        raise AssertionError(f"gbdt card vs CPU: margins differ by {err:.3e} with equal trees")
    bad = [(n, gap, sc) for n, gap, sc in ties if gap > GBDT_TIE_TOL * sc]
    if diffs and (not ties or bad):
        raise AssertionError(f"gbdt card vs CPU: differing splits that are no near-tie {bad or diffs[:4]}")

    # 3. Through the trainer: one GPU worker.
    storage = tempfile.mkdtemp(prefix="rtput-gbdt-")
    t0 = time.perf_counter()
    rt.init(**spec.init)
    backend = api._global_runtime().backend
    session_dir, controller = backend.session_dir, backend._controller_proc.pid
    try:
        log(f"gbdt: cluster up in {time.perf_counter() - t0:.2f} s, resources {rt.cluster_resources()}")

        def dataset(Xd, yd):
            rows = np.concatenate([Xd, yd[:, None]], axis=1)
            blocks = [rows[i:i + spec.block_rows] for i in range(0, len(rows), spec.block_rows)]
            return data.from_numpy(blocks).map_batches(lambda b: {"x": b["data"][:, :-1], "y": b["data"][:, -1]})

        trainer = XGBoostTrainer(
            datasets={"train": dataset(X, y), "valid": dataset(Xv, yv)}, label_column="y",
            params=dict(GBDT_XGB_PARAMS), num_boost_round=spec.rounds,
            # The rehearsal's CPU worker (it has no card); the card's run takes the default GPU worker.
            **({} if on_card else {"scaling_config": ScalingConfig(num_workers=1, use_gpu=False)}),
            run_config=RunConfig(storage_path=storage, name="gbdt"))
        trainer.train_loop_per_worker = _gbdt_loop_counted()
        t_fit = time.perf_counter()
        result = trainer.fit()
        trainer_fit_s = time.perf_counter() - t_fit
        if result.error:
            raise AssertionError(f"gbdt trainer: the run failed: {result.error}")
        m = result.metrics
        _sum_launches(counts, [m])
        digest = _xy_digest(X, y), _xy_digest(Xv, yv)
        in_order = tuple(m["digests"]) == digest
        got = gbdt.GradientBoostedTrees.from_dict(result.checkpoint.to_dict()["model"], device="cpu")
        equal = all(np.array_equal(got.trees[k], model.trees[k]) for k in model.trees)
        tdiffs = [] if equal else _split_differences(got.trees, model.trees)
        log(f"gbdt XGBoostTrainer on {'one GPU worker' if on_card else 'one CPU worker'}: fit() "
            f"{trainer_fit_s:.1f} s ({-(-spec.rows // spec.block_rows)} + {-(-spec.valid_rows // spec.block_rows)} "
            f"blocks of up to {spec.block_rows} rows); rows reached the "
            f"worker {'in the in-process order' if in_order else 'REORDERED'}; trees "
            f"{'equal to the in-process fit, bit for bit' if equal else f'differ at {tdiffs[:8]}'}; "
            f"train loss {m['train_loss']:.6f} (in process {hist[-1]:.6f}), valid log-loss "
            f"{m['valid_logloss']:.6f} (in process {valid_ll:.6f}), accuracy {m['valid_accuracy']:.4f}; launches "
            f"in the worker {m['launches']}")
        if in_order and not equal:
            raise AssertionError(f"gbdt trainer: rows in order, but the trees differ from the in-process fit's at "
                                 f"{tdiffs[:8]}")
        if not in_order:
            # Reordered rows sum in another order: hold the trees to the near-tie rule.
            ties = _first_round_ties(X, y, tdiffs, got.trees, model, p)
            log(f"gbdt trainer: rows reordered; first differing round's splits (node, gap, scale) {ties}")
            if any(gap > GBDT_TIE_TOL * sc for _, gap, sc in ties):
                raise AssertionError(f"gbdt trainer: reordered rows gave splits that are no near-tie: {ties}")
    finally:
        left = _end_session(controller, session_dir)
        shutil.rmtree(storage, ignore_errors=True)
    if left:
        raise AssertionError(f"gbdt: processes outlived shutdown (killed): {left}")
    launches["gbdt"] = counts
    log(f"gbdt launches {counts}; phase wall {time.perf_counter() - t_phase:.1f} s")
    if any(counts.get(k, 0) for k in _kernels()):
        raise AssertionError(f"gbdt: the booster launched an attention or RMSNorm kernel: {counts}")


def _xy_digest(X, y) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(X).tobytes() + np.ascontiguousarray(y).tobytes()).hexdigest()


def _gbdt_hist_share(one_round) -> float:
    """The share of one round's device time spent under the booster's
    `gbdt_hist` ranges (torch.profiler; nan when it recorded no device
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_round()
        torch.cuda.synchronize()
    events = prof.events()
    total = sum(e.time_range.end - e.time_range.start for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    hist = sum(e.device_time_total for e in events
               if e.name == "gbdt_hist" and e.device_type == torch.autograd.DeviceType.CPU)
    return hist / total if total > 0 else float("nan")


# ------------------------------------------------------------------ rllib
@dataclasses.dataclass
class RLlibSpec:
    """What the rllib phase trains. `learn`: BASELINE config #1, PPO
    CartPole-v1 (`rllib/tuned_examples/ppo/cartpole-ppo.yaml:4-6`) at the
    reference test's settings (`tests/test_rllib.py:36-44`), to
    `gate` mean reward within `max_steps` env steps; `remote_*`: the
    remote runners (CPU actors) and the remote learner (a GPU worker);
    `cnn`: the catalog's cnn encoder at Atari's observation shape. `device`
    None: the card; the CPU rehearsal (tests/test_torch_chip_smoke.py)
    passes a small size on "cpu"."""

    envs: int = 16
    batch: int = 2048
    minibatch: int = 256
    epochs: int = 10
    lr: float = 3e-4
    entropy: float = 0.01
    hidden: tuple = (64, 64)
    gate: float = 150.0
    max_steps: int = 100_000
    remote_runners: int = 2
    remote_envs: int = 8
    remote_iters: int = 3
    pendulum_iters: int = 2
    ma_iters: int = 3
    cnn_shape: tuple = (84, 84, 4)
    cnn_batch: int = 256
    init: dict = dataclasses.field(default_factory=lambda: {"log_to_driver": False})
    device: str | None = None


RL_TOL = 1e-5   # one PPO update card vs CPU (f32, TF32 off), of each tensor's largest entry
CNN_TOL = 1e-4  # the cnn encoder's f32 forward and gradients on the card, against the CPU's f64


def _ppo_config(spec: RLlibSpec, device):
    from ray_tpu_torch.rllib import PPOConfig

    return (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=spec.envs)
            .training(train_batch_size=spec.batch, minibatch_size=spec.minibatch, num_epochs=spec.epochs,
                      lr=spec.lr, entropy_coeff=spec.entropy, model={"hidden": spec.hidden})
            .debugging(seed=0).resources(device=device))


def _leaf_errors(got, want, floor: float = 1e-30) -> list:
    """|got - want| max over each leaf, over max(the leaf's largest |want|,
    floor); `floor=None`: over 1 + the leaf's largest |want| (the CPU
    parity tests' measure, `tests/torch_rl.py:close`)."""
    from ray_tpu_torch.rllib.utils.tree import tree_leaves

    out = []
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.detach().double().cpu(), w.detach().double().cpu()
        scale = 1.0 + float(w.abs().max()) if floor is None else max(float(w.abs().max()), floor)
        out.append(float((g - w).abs().max() / scale))
    return out


class _TimedStore:
    """The runtime module as Algorithm uses it (`self._ray`), its `put`
    timed: the weights' seconds into the store each iteration."""

    def __init__(self, ray, times: list):
        self._ray, self._times = ray, times

    def put(self, value):
        t0 = time.perf_counter()
        ref = self._ray.put(value)
        self._times.append(time.perf_counter() - t0)
        return ref

    def __getattr__(self, name):
        return getattr(self._ray, name)


class _LearnerTap:
    """Wraps an algorithm's sampling and learner update: each call's host
    seconds, the last batch the learner got, and how many it got."""

    def __init__(self, algo):
        self.sample_s, self.update_s, self.batch = [], [], None
        sample, update = algo._sample_batches, algo.learner_group.update

        def timed_sample():
            t0 = time.perf_counter()
            out = sample()
            self.sample_s.append(time.perf_counter() - t0)
            return out

        def timed_update(batch):
            self.batch = batch
            t0 = time.perf_counter()
            out = update(batch)
            self.update_s.append(time.perf_counter() - t0)
            return out

        algo._sample_batches, algo.learner_group.update = timed_sample, timed_update
        self._update = update

    @staticmethod
    def p50_ms(xs) -> float:
        return sorted(xs)[len(xs) // 2] * 1e3 if xs else float("nan")


def phase_rllib(launches: dict, spec: RLlibSpec | None = None) -> None:
    """RLlib's core and PPO on the card through their entry points: PPO
    CartPole-v1 (BASELINE config #1) with the learner and the local runner
    on the card, to mean reward 150 within 100,000 env steps; one PPO
    update on a recorded batch card vs CPU (f32, TF32 off); remote env
    runners (CPU actors) and a remote learner (a GPU worker), the step
    count exact and save -> restore bit-equal; PPO Pendulum-v1 (Gaussian)
    and MultiAgentPPO with two policies; the cnn encoder at Atari's shape
    card vs CPU. Records iterations and env steps to the gate, env
    steps/s, sample and update ms, the update's device busy and idle
    share, the GPU worker's boot and the weights' seconds through the
    store."""
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api
    from ray_tpu_torch.rllib import PPOConfig, make_env
    from ray_tpu_torch.rllib.algorithms import ppo
    from ray_tpu_torch.rllib.algorithms.multi_agent_ppo import MultiAgentPPOConfig
    from ray_tpu_torch.rllib.core import catalog
    from ray_tpu_torch.rllib.env.multi_agent import make_multi_agent
    from ray_tpu_torch.rllib.utils import optim
    from ray_tpu_torch.rllib.utils.optim import make_optimizer
    from ray_tpu_torch.rllib.utils.tree import to_device, to_numpy, tree_leaves, tree_unflatten_like

    spec = spec or RLlibSpec()
    on_card = spec.device is None
    device = "cuda" if on_card else spec.device
    t_phase = time.perf_counter()
    counts: dict = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        # 1. Learning: BASELINE config #1.
        algo = _ppo_config(spec, spec.device).build()
        tap = _LearnerTap(algo)
        best, curve, reached = float("-inf"), [], None
        t0 = time.perf_counter()
        with counted(counts):
            while True:
                r = algo.train()
                curve.append(round(r["episode_reward_mean"], 1))
                best = max(best, r["episode_reward_mean"])
                if best >= spec.gate:
                    reached = (r["training_iteration"], r["timesteps_total"])
                    break
                if r["timesteps_total"] + spec.batch > spec.max_steps:
                    break
        learn_s = time.perf_counter() - t0
        learner = algo.learner_group.local_learner
        steps_total = r["timesteps_total"]
        busy = None
        if on_card:
            busy = _profile("rllib ppo update (one iteration)", lambda: tap._update(tap.batch))
        log(f"rllib PPO CartPole-v1 on {device} (learner and local runner; {spec.envs} envs, batch {spec.batch}, "
            f"minibatch {spec.minibatch}, {spec.epochs} epochs, lr {spec.lr}, entropy {spec.entropy}, seed 0): "
            f"mean reward by iteration {curve}; "
            + (f"reached {spec.gate} at iteration {reached[0]}, {reached[1]} env steps" if reached else
               f"did NOT reach {spec.gate} within {spec.max_steps} env steps (best {best:.1f})")
            + f"; {steps_total / learn_s:.1f} env steps/s over {learn_s:.1f} s; per iteration sample "
            f"{_LearnerTap.p50_ms(tap.sample_s):.1f} ms, update {_LearnerTap.p50_ms(tap.update_s):.1f}"
            f" ms (p50 of {len(tap.update_s)}); device events in one update {busy}")
        if reached is None:
            raise AssertionError(f"rllib: PPO CartPole did not reach {spec.gate} within {spec.max_steps} env steps "
                                 f"(best {best:.1f}; by iteration {curve})")

        # 2. One update card vs CPU on the recorded batch, params and permutations.
        cfg = algo.config
        batch = tap.batch
        T, B = batch["rewards"].shape
        N = T * B
        perms = optim.minibatch_perms(torch.Generator().manual_seed(1), N, cfg.num_epochs, N // cfg.minibatch_size,
                              cfg.minibatch_size)
        state = to_numpy((learner.params, learner.opt_state))
        outs = {}
        for dev in (device, "cpu"):
            upd = ppo.make_ppo_update(algo.module, make_optimizer(cfg), cfg)
            with counted(counts):
                outs[dev] = upd.with_perms(to_device(state, dev), to_device(batch, dev), perms.to(dev))
        (p_dev, _), m_dev = outs[device]
        (p_cpu, _), m_cpu = outs["cpu"]
        perr = max(_leaf_errors(p_dev, p_cpu))
        merr = {k: abs(float(m_dev[k]) - float(m_cpu[k])) / max(abs(float(m_cpu[k])), 1e-30) for k in m_cpu}
        log(f"rllib one PPO update card vs CPU ({cfg.num_epochs} epochs x {N // cfg.minibatch_size} minibatches of "
            f"{cfg.minibatch_size}, f32, TF32 off): params worst {perr:.3e} of each tensor's largest entry; metrics "
            f"rel {({k: f'{v:.2e}' for k, v in merr.items()})} (tol {RL_TOL})")
        if perr > RL_TOL or max(merr.values()) > RL_TOL:
            raise AssertionError(f"rllib card vs CPU: params {perr:.3e}, metrics {merr} (tol {RL_TOL})")
        algo.stop()
        del algo, learner, outs

        # 3. Continuous and multi-agent, on the card.
        with counted(counts):
            pend = (PPOConfig().environment("Pendulum-v1").training(train_batch_size=512, minibatch_size=128,
                                                                      num_epochs=2)
                    .debugging(seed=0).resources(device=spec.device).build())
            pl = [pend.train()["info"]["learner"] for _ in range(spec.pendulum_iters)]
            pend.stop()
            ma_cfg = (MultiAgentPPOConfig()
                      .environment(ma_env_maker=make_multi_agent(lambda n, **kw: make_env("CartPole-v1", n), 2))
                      .training(train_batch_size=1024, minibatch_size=128, num_epochs=6, lr=3e-4, entropy_coeff=0.01)
                      .debugging(seed=0)
                      .multi_agent(policies=["p0", "p1"], policy_mapping_fn=lambda a: "p0" if a == "agent_0" else "p1")
                      .resources(device=spec.device))
            ma_cfg.num_instances = 8
            ma = ma_cfg.build()
            w0 = ma.learner_group.get_weights()
            ma_res = [ma.train() for _ in range(spec.ma_iters)]
            w1 = ma.learner_group.get_weights()
        start_equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(w0["p0"]), tree_leaves(w0["p1"])))
        apart = not all(torch.equal(a, b) for a, b in zip(tree_leaves(w1["p0"]), tree_leaves(w1["p1"])))
        slots = dict(ma._runner.slots)
        on = {pid: tree_leaves(w)[0].device.type for pid, w in w1.items()}
        log(f"rllib PPO Pendulum-v1 (Gaussian) on {device}: total_loss by iteration "
            f"{[round(x['total_loss'], 4) for x in pl]}; MultiAgentPPO two policies on MultiCartPole: slots {slots}, "
            f"weights on {on}, equal at the start {start_equal}, apart after {spec.ma_iters} iterations {apart}; "
            f"policy reward means {[r['policy_reward_mean'] for r in ma_res][-1]}; env steps per iteration "
            f"{[r['num_env_steps_sampled_this_iter'] for r in ma_res]}")
        if not all(math.isfinite(x["total_loss"]) for x in pl):
            raise AssertionError(f"rllib pendulum: non-finite loss {pl}")
        if slots != {"p0": ["agent_0"], "p1": ["agent_1"]} or not start_equal or not apart or \
                set(on.values()) != {device}:
            raise AssertionError(f"rllib multi-agent: slots {slots}, start equal {start_equal}, apart {apart}, "
                                 f"devices {on}")
        ma.stop()

        # 4. The catalog's cnn encoder at Atari's shape: the card's f32
        # forward and gradients against the CPU's f64 ones (and the CPU's
        # f32 beside them). The loss is a value regression to 0,
        # 0.5·mean(feat²): its gradient vanishes where a ReLU turns, so a
        # unit that rounding moves across zero changes nothing.
        enc = catalog.build_encoder({"encoder": "cnn", "obs_shape": spec.cnn_shape}, int(np.prod(spec.cnn_shape)))
        cparams = enc.init(torch.Generator().manual_seed(3))
        obs = np.random.default_rng(4).uniform(0, 1, (spec.cnn_batch, int(np.prod(spec.cnn_shape)))).astype(np.float32)
        res = {}
        for dev, dtype in ((device, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
            leaves = [t.to(dev, dtype).requires_grad_() for t in tree_leaves(cparams)]
            with counted(counts):
                feat = enc.apply(tree_unflatten_like(cparams, leaves), torch.as_tensor(obs, device=dev, dtype=dtype))
                grads = torch.autograd.grad(0.5 * (feat ** 2).mean(), leaves)
            res[dev, dtype] = [feat.detach(), *grads]
        cerr = _leaf_errors(res[device, torch.float32], res["cpu", torch.float64])
        f32err = _leaf_errors(res["cpu", torch.float32], res["cpu", torch.float64])
        pair = _leaf_errors(res[device, torch.float32], res["cpu", torch.float32])
        log(f"rllib cnn encoder {spec.cnn_shape} (filters (16, 4, 2), (32, 4, 2), head 256), batch {spec.cnn_batch}, "
            f"f32, TF32 off, loss 0.5*mean(feat^2): the card against the CPU's f64, of each tensor's largest entry: "
            f"forward {cerr[0]:.3e}, gradients {[f'{e:.2e}' for e in cerr[1:]]} (tol {CNN_TOL}); the CPU's f32 "
            f"against its f64 {[f'{e:.2e}' for e in f32err]}; card vs CPU f32 {[f'{e:.2e}' for e in pair]}")
        if max(cerr) > CNN_TOL:
            raise AssertionError(f"rllib cnn: the card's f32 against the CPU's f64 {cerr} (tol {CNN_TOL})")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # 5. Remote runners (CPU actors) and a remote learner (a GPU worker).
    rt.init(**spec.init)
    backend = api._global_runtime().backend
    session_dir, controller = backend.session_dir, backend._controller_proc.pid
    ckpt = tempfile.mkdtemp(prefix="rtput-rllib-")
    try:
        rcfg = (_ppo_config(spec, spec.device)
                .env_runners(num_env_runners=spec.remote_runners, num_envs_per_env_runner=spec.remote_envs)
                .resources(remote_learner=True))
        t0 = time.perf_counter()
        with counted(counts):
            ralgo = rcfg.build()
        boot_s = time.perf_counter() - t0
        put_s: list = []
        ralgo._ray = _TimedStore(ralgo._ray, put_s)
        get_w = ralgo.learner_group.get_weights
        get_s: list = []

        def timed_get_weights():
            t0 = time.perf_counter()
            w = get_w()
            get_s.append(time.perf_counter() - t0)
            return w

        ralgo.learner_group.get_weights = timed_get_weights
        with counted(counts):
            rres = [ralgo.train() for _ in range(spec.remote_iters)]
        steps = [x["num_env_steps_sampled_this_iter"] for x in rres]
        losses = [x["info"]["learner"]["total_loss"] for x in rres]
        ralgo.save(ckpt)
        want = get_w()
        ralgo.stop()
        local = _ppo_config(spec, spec.device).build()
        local.restore(ckpt)
        got = local.learner_group.get_weights()
        local.stop()
        restored = all(np.array_equal(a, b) for a, b in zip(tree_leaves(want), tree_leaves(got)))
        w_bytes = sum(a.nbytes for a in tree_leaves(want))
        log(f"rllib remote: {spec.remote_runners} env runners (CPU actors, {spec.remote_envs} envs each) and a remote "
            f"learner on a {'GPU' if on_card else 'CPU'} worker: build() {boot_s:.2f} s (the learner's worker boot, "
            f"its params, the runners' boot); env steps per iteration {steps}; total_loss {losses}; weights "
            f"({w_bytes} bytes) into the store {[round(s * 1e3, 3) for s in put_s]} ms, out of the learner "
            f"{[round(s * 1e3, 3) for s in get_s]} ms per iteration; save -> restore into a new (local) algorithm: "
            f"{'bit for bit' if restored else 'NOT equal'}")
        if steps != [spec.batch] * spec.remote_iters or not all(math.isfinite(x) for x in losses) or not restored:
            raise AssertionError(f"rllib remote: steps {steps}, losses {losses}, restored {restored}")
    finally:
        left = _end_session(controller, session_dir)
        shutil.rmtree(ckpt, ignore_errors=True)
    if left:
        raise AssertionError(f"rllib: processes outlived shutdown (killed): {left}")
    launches["rllib"] = counts
    log(f"rllib launches (driver side; the remote learner's process is not read) {counts}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    if any(counts.get(k, 0) for k in _kernels()):
        raise AssertionError(f"rllib: an attention or RMSNorm kernel was launched: {counts}")


# ------------------------------------------------------------- rllib_algos
# name -> (mean reward bar, iteration limit): the reference tests' own
# (`tests/test_rllib_algos.py:37-74,194-207`, `tests/test_rllib_offline.py:30-48,167-202`).
RL_BARS = {"dqn": (130.0, 80), "impala": (130.0, 250), "appo": (130.0, 250), "a2c": (120.0, 150),
           "bc": (150.0, 10), "marwil": (150.0, 15)}


@dataclasses.dataclass
class RLlibAlgosSpec:
    """What the rllib_algos phase runs. `bars`: each algorithm's learning
    bar and iteration limit at the reference test's settings and seed;
    `async_*`: IMPALA's async path (remote CPU-actor runners, the learner
    on the card); `apex_*`: Ape-X with its replay shards; `cql_iters`: CQL
    on transition data (no bar: the reference has no test of it). `device`
    None: the card; the CPU rehearsal (tests/test_torch_chip_smoke.py)
    passes low bars on "cpu"."""

    bars: dict = dataclasses.field(default_factory=lambda: dict(RL_BARS))
    async_runners: int = 2
    async_envs: int = 8
    async_iters: int = 5
    apex_runners: int = 2
    apex_shards: int = 2
    apex_iters: int = 4
    cql_iters: int = 3
    init: dict = dataclasses.field(default_factory=lambda: {"log_to_driver": False})
    device: str | None = None


def _cartpole_expert(obs):
    """The reference tests' scripted CartPole expert (`tests/test_rllib_offline.py:14-17`)."""
    import numpy as np

    return (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(np.int64)


def _rl_algo_configs(device) -> dict:
    """name -> zero-arg builder of the algorithm at its reference test's
    settings and seed, its learner and local runner on `device`."""
    import numpy as np

    from ray_tpu_torch.rllib import (A2CConfig, APPOConfig, BCConfig, DQNConfig, IMPALAConfig,
                                     MARWILConfig)
    from ray_tpu_torch.rllib.offline import OfflineDataset, collect_dataset

    def bc():
        demos = collect_dataset("CartPole-v1", _cartpole_expert, n_steps=4096, num_envs=8, seed=3)
        return (BCConfig().environment("CartPole-v1").training(lr=1e-3, train_batch_size=2048)
                .offline_data(dataset=demos).resources(device=device).build())

    def marwil():
        rng = np.random.default_rng(0)
        expert = collect_dataset("CartPole-v1", _cartpole_expert, n_steps=3072, num_envs=8, seed=5)
        rand = collect_dataset("CartPole-v1", lambda obs: rng.integers(0, 2, size=len(obs)), n_steps=3072,
                               num_envs=8, seed=6)
        mixed = OfflineDataset(np.concatenate([expert.obs, rand.obs]), np.concatenate([expert.actions, rand.actions]),
                               np.concatenate([expert.returns, rand.returns]))
        return (MARWILConfig().environment("CartPole-v1").training(lr=1e-3, train_batch_size=2048, beta=1.0)
                .offline_data(dataset=mixed).resources(device=device).build())

    return {
        "dqn": lambda: (DQNConfig().environment("CartPole-v1")
                        .env_runners(num_env_runners=0, num_envs_per_env_runner=8)
                        .training(train_batch_size=512, learning_starts=1000, num_grad_steps=64,
                                  epsilon_decay_steps=10_000, lr=5e-4)
                        .debugging(seed=0).resources(device=device).build()),
        "impala": lambda: (IMPALAConfig().environment("CartPole-v1")
                           .env_runners(num_env_runners=0, num_envs_per_env_runner=16, rollout_fragment_length=16)
                           .training(train_batch_size=256, lr=1e-3, entropy_coeff=0.01)
                           .debugging(seed=0).resources(device=device).build()),
        "appo": lambda: (APPOConfig().environment("CartPole-v1")
                         .env_runners(num_env_runners=0, num_envs_per_env_runner=16, rollout_fragment_length=16)
                         .training(train_batch_size=256, lr=1e-3, entropy_coeff=0.005)
                         .debugging(seed=0).resources(device=device).build()),
        "a2c": lambda: (A2CConfig().environment("CartPole-v1")
                        .env_runners(num_env_runners=0, num_envs_per_env_runner=16)
                        .training(train_batch_size=1024, lr=7e-4, model={"hidden": (64, 64)})
                        .debugging(seed=0).resources(device=device).build()),
        "bc": bc,
        "marwil": marwil,
    }


def _rl_update_pair(learner, state, batch, device, perms=None):
    """The learner's update from `state` on `batch`, on `device` and on the
    CPU (permutations given when the update draws them): (params worst
    error of each tensor's largest entry, metrics worst |d| / max(|cpu|, 1))."""
    from ray_tpu_torch.rllib.utils.tree import to_device

    outs = {}
    for dev in (device, "cpu"):
        fn = learner._update if perms is None else learner._update.with_perms
        args = (to_device(state, dev), to_device(batch, dev))
        outs[dev] = fn(*args, perms.to(dev)) if perms is not None else fn(*args, None)
    (p_dev, _), m_dev = outs[device]
    (p_cpu, _), m_cpu = outs["cpu"]
    merr = max(abs(float(m_dev[k]) - float(m_cpu[k])) / max(abs(float(m_cpu[k])), 1.0) for k in m_cpu)
    return max(_leaf_errors(p_dev, p_cpu)), merr


def phase_rllib_algos(launches: dict, spec: RLlibAlgosSpec | None = None) -> None:
    """RLlib's discrete-action algorithms on the card through their entry
    points: DQN, IMPALA, APPO, A2C, BC and MARWIL to their reference tests'
    learning bars (settings, seeds and iteration limits the tests'), the
    learner and the local runner on the card; one update of each of the
    eight (Ape-X and CQL too) card vs CPU (f32, TF32 off); IMPALA's async
    path with remote CPU-actor runners; Ape-X with its replay shards; CQL
    on transition data. Records iterations and env steps to each bar, env
    steps/s, sample and update ms, the DQN update's device idle share, the
    card-vs-CPU errors, the shards' sizes and priority writes."""
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api
    from ray_tpu_torch.rllib import ApexDQNConfig, CQLConfig, IMPALAConfig
    from ray_tpu_torch.rllib.offline import collect_dataset
    from ray_tpu_torch.rllib.utils import optim
    from ray_tpu_torch.rllib.utils.tree import to_numpy

    spec = spec or RLlibAlgosSpec()
    on_card = spec.device is None
    device = "cuda" if on_card else spec.device
    t_phase = time.perf_counter()
    counts: dict = {}
    errors: dict = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        # 1. Learning bars; 2. each algorithm's update card vs CPU on its last batch.
        builders = _rl_algo_configs(spec.device)
        missed = []
        for name, (bar, max_iters) in spec.bars.items():
            algo = builders[name]()
            tap = _LearnerTap(algo)
            offline = name in ("bc", "marwil")
            best, curve, reached = float("-inf"), [], None
            t0 = time.perf_counter()
            with counted(counts):
                for _ in range(max_iters):
                    r = algo.train()
                    m = r["evaluation"]["episode_reward_mean"] if offline else r["episode_reward_mean"]
                    curve.append(round(m, 1))
                    if np.isfinite(m):
                        best = max(best, m)
                    if best >= bar:
                        reached = (r["training_iteration"], r["timesteps_total"])
                        break
            learn_s = time.perf_counter() - t0
            steps = r["timesteps_total"]
            learner = algo.learner_group.local_learner
            busy = None
            if name == "dqn" and on_card:
                busy = _profile("rllib_algos dqn update (one iteration, 64 minibatches)",
                                lambda: tap._update(tap.batch))
            log(f"rllib_algos {name} CartPole-v1 on {device}: mean reward by iteration {curve}; "
                + (f"reached {bar} at iteration {reached[0]}, {reached[1]} env steps" if reached else
                   f"did NOT reach {bar} within {max_iters} iterations (best {best:.1f})")
                + f"; {learn_s:.1f} s"
                + (f", {steps / learn_s:.1f} env steps/s" if steps else "")
                + f"; per iteration sample {_LearnerTap.p50_ms(tap.sample_s):.1f} ms, update "
                f"{_LearnerTap.p50_ms(tap.update_s):.1f} ms (p50 of {len(tap.update_s)})"
                + (f"; device events in one update {busy}" if busy is not None else ""))
            if reached is None:
                missed.append(f"{name} best {best:.1f} < {bar} in {max_iters}")
            state = to_numpy((learner.params, learner.opt_state))
            perms = None
            if offline:
                cfg = algo.config
                n_mb = cfg.train_batch_size // cfg.minibatch_size
                perms = optim.minibatch_perms(torch.Generator().manual_seed(1), cfg.train_batch_size, cfg.num_epochs, n_mb,
                                      cfg.minibatch_size)
            with counted(counts):
                errors[name] = _rl_update_pair(learner, state, tap.batch, device, perms)
            algo.stop()
        if missed:
            raise AssertionError(f"rllib_algos: learning bars missed: {missed}")

        # CQL on transition data (3 iterations; no bar, as the reference has no test).
        ds = collect_dataset("CartPole-v1", _cartpole_expert, n_steps=4096, num_envs=8, seed=3, transitions=True)
        cql = CQLConfig().environment("CartPole-v1").offline_data(dataset=ds).debugging(seed=0) \
            .resources(device=spec.device).build()
        tap = _LearnerTap(cql)
        t0 = time.perf_counter()
        with counted(counts):
            cres = [cql.train() for _ in range(spec.cql_iters)]
        cql_s = time.perf_counter() - t0
        cm = [r["info"]["learner"] for r in cres]
        learner = cql.learner_group.local_learner
        cfg = cql.config
        perms = optim.minibatch_perms(torch.Generator().manual_seed(1), cfg.train_batch_size, cfg.num_epochs,
                              cfg.train_batch_size // cfg.minibatch_size, cfg.minibatch_size)
        with counted(counts):
            errors["cql"] = _rl_update_pair(learner, to_numpy((learner.params, learner.opt_state)), tap.batch,
                                            device, perms)
        cql.stop()
        log(f"rllib_algos cql on {device} ({len(ds)} expert transitions, batch {cfg.train_batch_size}, "
            f"{cfg.num_epochs} epochs of {cfg.train_batch_size // cfg.minibatch_size} minibatches): td_loss "
            f"{[round(m['td_loss'], 5) for m in cm]}, cql_penalty {[round(m['cql_penalty'], 5) for m in cm]}, "
            f"greedy evaluation {[round(r['evaluation']['episode_reward_mean'], 1) for r in cres]}; {cql_s:.1f} s, "
            f"update {_LearnerTap.p50_ms(tap.update_s):.1f} ms (p50)")
        if not all(math.isfinite(m["td_loss"]) and math.isfinite(m["cql_penalty"]) for m in cm):
            raise AssertionError(f"rllib_algos cql: non-finite losses {cm}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # 3. IMPALA's async path and 4. Ape-X, on one cluster.
    rt.init(**spec.init)
    backend = api._global_runtime().backend
    session_dir, controller = backend.session_dir, backend._controller_proc.pid
    try:
        algo = (IMPALAConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=spec.async_runners, num_envs_per_env_runner=spec.async_envs,
                             rollout_fragment_length=16)
                .training(train_batch_size=256, lr=1e-3, entropy_coeff=0.01, broadcast_interval=2)
                .debugging(seed=0).resources(device=spec.device).build())
        puts: list = []
        algo._ray = _TimedStore(algo._ray, puts)
        tap = _LearnerTap(algo)
        rearmed, rhos, t0 = [], [], time.perf_counter()
        with counted(counts):
            for _ in range(spec.async_iters):
                r = algo.train()
                rearmed.append(sorted(map(id, algo._inflight.values())) == sorted(map(id, algo._remote_runners)))
                rhos.append(r["info"]["learner"].get("mean_rho", float("nan")))
        async_s = time.perf_counter() - t0
        frag = 16 * spec.async_envs
        consumed = len(tap.update_s)
        steps = r["timesteps_total"]
        want_puts = spec.async_iters + consumed // 2
        log(f"rllib_algos impala async: {spec.async_runners} runners (CPU actors, {spec.async_envs} envs, fragments "
            f"of {frag} steps), the learner on {device}, {spec.async_iters} iterations: {consumed} fragments "
            f"consumed, {steps} env steps ({steps / async_s:.1f}/s), every consumed runner re-armed {all(rearmed)}, "
            f"weights put {len(puts)} times (want {want_puts}: one arming per iteration, one per 2 updates), "
            f"update {_LearnerTap.p50_ms(tap.update_s):.1f} ms (p50), mean_rho by iteration {rhos}")
        algo.stop()
        if steps != frag * consumed or not all(rearmed) or len(puts) != want_puts \
                or not all(math.isfinite(x) for x in rhos):
            raise AssertionError(f"rllib_algos impala async: steps {steps} for {consumed} fragments, re-armed "
                                 f"{rearmed}, puts {len(puts)} (want {want_puts}), mean_rho {rhos}")

        apex = (ApexDQNConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=spec.apex_runners, num_envs_per_env_runner=8)
                .training(num_replay_shards=spec.apex_shards).debugging(seed=0).resources(device=spec.device).build())
        td_errors, writes, mbs = apex._td_errors, [], []

        def counted_td(batch):
            out = td_errors(batch)
            writes.append((batch["obs"].shape[0] * batch["obs"].shape[1], out.size))
            mbs[:] = [batch]
            return out

        apex._td_errors = counted_td
        t0 = time.perf_counter()
        with counted(counts):
            ares = [apex.train() for _ in range(spec.apex_iters)]
        apex_s = time.perf_counter() - t0
        sizes = rt.get([s.size.remote() for s in apex._shards])
        pushed = ares[-1]["timesteps_total"]
        weights = [rt.get(s.sample.remote(1, 256))[0]["weights"] for s in apex._shards]
        moved = all(float(w.min()) < 1.0 for w in weights)
        best = max((r["episode_reward_mean"] for r in ares if math.isfinite(r["episode_reward_mean"])),
                   default=float("nan"))
        td_loss = ares[-1]["info"]["learner"]["td_loss"]
        learner = apex.learner_group.local_learner
        with counted(counts):
            errors["apex_dqn"] = _rl_update_pair(learner, to_numpy((learner.params, learner.opt_state)), mbs[0],
                                                 device)
        log(f"rllib_algos apex_dqn: {spec.apex_runners} runners (CPU actors, 8 envs), {spec.apex_shards} replay "
            f"shards (CPU actors), the learner on {device}, {spec.apex_iters} iterations: shard sizes {sizes} "
            f"(sum {sum(sizes)}, env steps pushed {pushed}); {len(writes)} priority writes of "
            f"{sorted(set(n for n, _ in writes))} transitions each ({'one per sampled index' if all(n == m for n, m in writes) else 'NOT one per index'}); "
            f"sampling weights below 1 after the writes {moved}; td_loss {td_loss:.5f}; best mean reward {best:.1f} "
            f"(no bar: the reference has none); {pushed / apex_s:.1f} env steps/s")
        apex.stop()
        if sum(sizes) != pushed or not writes or not all(n == m for n, m in writes) or not moved \
                or not math.isfinite(td_loss):
            raise AssertionError(f"rllib_algos apex: sizes {sizes} vs {pushed}, writes {writes}, moved {moved}, "
                                 f"td_loss {td_loss}")
    finally:
        left = _end_session(controller, session_dir)
    if left:
        raise AssertionError(f"rllib_algos: processes outlived shutdown (killed): {left}")

    log("rllib_algos one update card vs CPU (f32, TF32 off; params: worst of each tensor's largest entry, "
        "metrics: worst |d| / max(|cpu|, 1)): "
        + ", ".join(f"{k} {p:.3e} / {m:.3e}" for k, (p, m) in errors.items()) + f" (tol {RL_TOL})")
    bad = {k: v for k, v in errors.items() if max(v) > RL_TOL}
    if bad:
        raise AssertionError(f"rllib_algos card vs CPU above {RL_TOL}: {bad}")
    launches["rllib_algos"] = counts
    log(f"rllib_algos launches {counts}; phase wall {time.perf_counter() - t_phase:.1f} s")
    if any(counts.get(k, 0) for k in _kernels()):
        raise AssertionError(f"rllib_algos: an attention or RMSNorm kernel was launched: {counts}")


# ---------------------------------------------------------- rllib_algos_ii
# name -> (mean reward bar, iteration limit): the reference tests' own
# (`tests/test_rllib_algos.py:76-89,174-190,210-226`, `tests/test_rllib_dt.py:44-67`).
RL_BARS_II = {"sac": (-350.0, 200), "td3": (-350.0, 200), "ddpg": (-400.0, 200), "dt": (150.0, 8)}
# The Pendulum tests' settings (`tests/test_rllib_algos.py:80-86,178-184,214-220`).
PENDULUM_TRAINING = dict(train_batch_size=256, learning_starts=512, num_grad_steps=256, minibatch_size=128,
                         model={"hidden": (64, 64)})
PENDULUM_LR = {"sac": 3e-4, "td3": 1e-3, "ddpg": 1e-3}
# The card-vs-CPU update of SAC, TD3 and DDPG: the first 32 minibatches of
# the last iteration's 256 (each CPU step ≈ 15-30 ms on the card's host).
CARD_VS_CPU_STEPS = 32


@dataclasses.dataclass
class RLlibAlgosIISpec:
    """What the rllib_algos_ii phase runs. `bars`: each algorithm's learning
    bar and iteration limit at the reference test's settings and seed;
    `dt_episodes`: DT's scripted-expert episodes (`collect_episodes(...,
    seed=3)`). `device` None: the card; the CPU rehearsal
    (tests/test_torch_chip_smoke.py) passes low bars on "cpu", and
    `training` there shrinks the Pendulum updates (the card runs the tests'
    settings as they are)."""

    bars: dict = dataclasses.field(default_factory=lambda: dict(RL_BARS_II))
    dt_episodes: int = 40
    training: dict = dataclasses.field(default_factory=dict)
    device: str | None = None


def _rl_algo_ii_configs(device, training: dict) -> dict:
    """name -> zero-arg builder of the algorithm at its reference test's
    settings and seed, its learner and local runner on `device`."""
    from ray_tpu_torch.rllib import DDPGConfig, DTConfig, SACConfig, TD3Config
    from ray_tpu_torch.rllib.offline import collect_episodes

    def pendulum(config, name):
        return lambda: (config.environment("Pendulum-v1")
                        .env_runners(num_env_runners=0, num_envs_per_env_runner=8)
                        .training(**{**PENDULUM_TRAINING, "lr": PENDULUM_LR[name], **training})
                        .debugging(seed=0).resources(device=device).build())

    def dt(n_episodes: int):
        demos = collect_episodes("CartPole-v1", _cartpole_expert, n_episodes=n_episodes, seed=3)
        return (DTConfig().environment("CartPole-v1")
                .training(lr=1e-3, context_length=20, embed_dim=64, num_layers=2, num_heads=2,
                          train_batch_size=256, minibatch_size=64, target_return=190.0, max_ep_len=220)
                .offline_data(demos).resources(device=device).build())

    return {"sac": pendulum(SACConfig(), "sac"), "td3": pendulum(TD3Config(), "td3"),
            "ddpg": pendulum(DDPGConfig(), "ddpg"), "dt": dt}


def _graph_against_eager(update, state, batch, draws) -> dict:
    """From one state, the update replaying its CUDA graphs and the same
    steps eagerly (`optim.scan_steps` of `update.step`) on the card: ms a
    gradient step each way, and whether params, optimizer state and metrics
    are equal bit for bit."""
    import torch

    from ray_tpu_torch.rllib.utils import optim
    from ray_tpu_torch.rllib.utils.tree import tree_leaves

    k = batch["obs"].shape[0]
    out, ms = {}, {}
    for how in ("graph", "eager", "graph"):  # the graph's ms: the second, warm call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "graph":
            out[how] = update.with_draws(state, batch, draws)
        else:
            out[how] = optim.scan_steps(update.step, state, *update.scan_inputs(batch, draws))
        torch.cuda.synchronize()
        ms[how] = (time.perf_counter() - t0) * 1e3 / k
    (gs, gm), (es, em) = out["graph"], out["eager"]
    equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(gs), tree_leaves(es))) and \
        all(torch.equal(gm[name], em[name]) for name in em)
    return {"graph_ms": ms["graph"], "eager_ms": ms["eager"], "equal": equal, "steps": k}


def phase_rllib_algos_ii(launches: dict, spec: RLlibAlgosIISpec | None = None) -> None:
    """SAC, TD3, DDPG and the Decision Transformer on the card through their
    entry points: each to its reference test's learning bar (settings, seed
    and iteration limit the tests'), the learner and the local runner on
    the card. At the first update of each Pendulum run, before its bar, the
    update replaying its CUDA graphs against the same gradient steps eager
    on the card (bit for bit; ms a gradient step each way); after the bar,
    one update card vs CPU (f32, TF32 off) from the learner's last state,
    given the same draws (DT: permutations), step by step
    (`_update_card_vs_cpu`). Records iterations and env
    steps to each bar, sample and update ms (p50), one profiled update's
    device idle share, and the phase wall."""
    import numpy as np
    import torch

    from ray_tpu_torch.rllib.utils.tree import to_device

    spec = spec or RLlibAlgosIISpec()
    on_card = spec.device is None
    device = "cuda" if on_card else spec.device
    t_phase = time.perf_counter()
    counts: dict = {}
    errors: dict = {}
    graphs: dict = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        builders = _rl_algo_ii_configs(spec.device, spec.training)
        missed = []
        for name, (bar, max_iters) in spec.bars.items():
            offline = name == "dt"
            t_build = time.perf_counter()
            algo = builders[name](spec.dt_episodes) if offline else builders[name]()
            build_s = time.perf_counter() - t_build
            tap = _LearnerTap(algo)
            learner = algo.learner_group.local_learner
            best, curve, reached, iter_s = float("-inf"), [], None, []
            t0 = time.perf_counter()
            with counted(counts):
                for _ in range(max_iters):
                    t_it = time.perf_counter()
                    r = algo.train()
                    iter_s.append(time.perf_counter() - t_it)
                    if not offline and name not in graphs and tap.batch is not None and on_card:
                        # The first update: its graph against its eager steps, before any bar.
                        draws = _draws(name, tap.batch, device, learner._update)
                        graphs[name] = _graph_against_eager(learner._update, learner.state,
                                                            to_device(tap.batch, device), draws)
                        g = graphs[name]
                        log(f"rllib_algos_ii {name} first update (iteration {r['training_iteration']}, {g['steps']} "
                            f"gradient steps): graphed {g['graph_ms']:.4f} ms a step, eager {g['eager_ms']:.4f} ms "
                            f"a step on the card, {g['eager_ms'] / g['graph_ms']:.2f}x; replay against eager "
                            f"{'bit for bit' if g['equal'] else 'NOT equal'}; that iteration sample "
                            f"{tap.sample_s[-1] * 1e3:.1f} ms, update {tap.update_s[-1] * 1e3:.1f} ms "
                            f"(the capture included)")
                    m = r["evaluation"]["episode_reward_mean"] if offline else r["episode_reward_mean"]
                    curve.append(round(m, 1))
                    if np.isfinite(m):
                        best = max(best, m)
                    if best >= bar:
                        reached = (r["training_iteration"], r["timesteps_total"])
                        break
            learn_s = time.perf_counter() - t0
            busy = None
            if on_card and name == "sac":  # the largest graph; its profile stands for the three
                busy = _profile(f"rllib_algos_ii {name} update (one iteration)", lambda: tap._update(tap.batch))
            env = "CartPole-v1" if offline else "Pendulum-v1"
            log(f"rllib_algos_ii {name} {env} on {device}: mean reward by iteration {curve}; "
                + (f"reached {bar} at iteration {reached[0]}, {reached[1]} env steps" if reached else
                   f"did NOT reach {bar} within {max_iters} iterations (best {best:.1f})")
                + f"; {learn_s:.1f} s (build {build_s:.1f} s); per iteration {_LearnerTap.p50_ms(iter_s):.1f} ms, "
                + ("" if offline else f"sample {_LearnerTap.p50_ms(tap.sample_s):.1f} ms, ")
                + f"update {_LearnerTap.p50_ms(tap.update_s):.1f} ms (p50 of {len(tap.update_s)})"
                + (f"; device events in one update {busy}" if busy is not None else ""))
            if reached is None:
                missed.append(f"{name} best {best:.1f} < {bar} in {max_iters}")
            # One update card vs CPU from the learner's last state, given the same draws.
            t_check = time.perf_counter()
            with counted(counts):
                errors[name] = _update_card_vs_cpu(name, algo, learner, tap.batch, device)
            e = errors[name]
            log(f"rllib_algos_ii {name} one update card vs CPU ({e['steps']} gradient steps from the learner's last "
                f"state, f32, TF32 off, the same draws or permutations), each step on the card from the CPU's state "
                f"before it: params worst {e['params']:.3e} of 1 + the tensor's largest entry ({e['leaf']}, step "
                f"{e['step']}; of the largest entry alone {e['relative']:.3e}, {e['relative_leaf']}), metrics "
                f"{e['metrics']:.3e}; the {e['steps']} steps run through on each device: params {e['through']:.3e} "
                f"of the largest entry ({e['through_leaf']}); {time.perf_counter() - t_check:.1f} s")
            algo.stop()
        if missed:
            raise AssertionError(f"rllib_algos_ii: learning bars missed: {missed}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    log("rllib_algos_ii one update card vs CPU, step by step (f32, TF32 off, the same draws or permutations; "
        "params: worst |d| / (1 + the tensor's largest entry), metrics: worst |d| / max(|cpu|, 1)): "
        + ", ".join(f"{k} {e['params']:.3e} / {e['metrics']:.3e}" for k, e in errors.items()) + f" (tol {RL_TOL})")
    bad = {k: (e["params"], e["metrics"]) for k, e in errors.items() if max(e["params"], e["metrics"]) > RL_TOL}
    if bad:
        raise AssertionError(f"rllib_algos_ii card vs CPU above {RL_TOL}: {bad}")
    unequal = [k for k, g in graphs.items() if not g["equal"]]
    if on_card and (unequal or set(graphs) != {k for k in spec.bars if k != "dt"}):
        raise AssertionError(f"rllib_algos_ii: graph replay against eager not bit-equal for {unequal} "
                             f"(checked {sorted(graphs)})")
    launches["rllib_algos_ii"] = counts
    log(f"rllib_algos_ii launches {counts}; phase wall {time.perf_counter() - t_phase:.1f} s")
    if any(counts.get(k, 0) for k in _kernels()):
        raise AssertionError(f"rllib_algos_ii: an attention or RMSNorm kernel was launched: {counts}")


def _leaf_names(tree, prefix: str = "") -> list:
    """The path of each leaf, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree) for n in _leaf_names(t, f"{prefix}/{i}")]
    return [prefix or "/"]


def _update_card_vs_cpu(name: str, algo, learner, batch, device) -> dict:
    """One update of the learner's (its gradient steps on `batch`, from its
    last state, given draws or permutations from a CPU generator seeded 1;
    SAC, TD3 and DDPG on the batch's first CARD_VS_CPU_STEPS minibatches,
    DreamerV3 on its k sequence batches)
    card vs CPU, step by step: step i on the card starts from the CPU's
    state after step i - 1, and its params and metrics are held to the
    CPU's step i, each tensor within tol·(1 + its largest |entry|) (the CPU
    parity tests' measure) and each metric within tol·max(|cpu|, 1). A
    chain of Adam steps carries round-off forward and, at a trained state,
    grows it (a ReLU that turns, a tanh at its bound), so each step is
    compared from one state; the k steps run through on each device are
    compared too, and recorded. Returns the gated worst ("params", its
    leaf and step), the worst of |d| / the tensor's largest |entry|
    ("relative"), the worst metric, and the run-through's."""
    import torch

    from ray_tpu_torch.rllib.utils import optim
    from ray_tpu_torch.rllib.utils.tree import to_device, to_numpy, tree_map

    update = learner._update
    state = to_device(to_numpy(learner.state), "cpu")
    if name == "dt":
        cfg = algo.config
        n_mb = cfg.train_batch_size // cfg.minibatch_size
        perms = optim.minibatch_perms(torch.Generator().manual_seed(1), cfg.train_batch_size, cfg.num_epochs, n_mb,
                                      cfg.minibatch_size)
        data = {dev: to_device(batch, dev) for dev in (device, "cpu")}

        def step(st, i, dev):
            e, j = divmod(i, n_mb)
            return update.with_perms(st, data[dev], perms[e:e + 1, j:j + 1].to(dev))

        def through(st, dev):
            return update.with_perms(st, data[dev], perms.to(dev))

        steps = cfg.num_epochs * n_mb
    else:
        batch = {k: v[:CARD_VS_CPU_STEPS] for k, v in batch.items()}
        draws = _draws(name, batch, "cpu", update)
        scan = {dev: update.scan_inputs(to_device(batch, dev), to_device(draws, dev)) for dev in (device, "cpu")}
        variants = scan["cpu"][1]

        def step(st, i, dev):
            return update.program(st, tree_map(lambda x: x[i:i + 1], scan[dev][0]), [variants[i]])

        def through(st, dev):
            return update.program(st, *scan[dev])

        steps = len(variants)
    names = _leaf_names(state[0])
    worst = {"params": 0.0, "leaf": "", "step": 0, "metrics": 0.0, "relative": 0.0, "relative_leaf": ""}
    for i in range(steps):
        (p_dev, _), m_dev = step(to_device(state, device), i, device)
        p_dev = to_device(p_dev, "cpu")
        m_dev = dict(zip(m_dev, torch.stack(list(m_dev.values())).cpu()))
        state, m_cpu = step(state, i, "cpu")
        errs, rel = _leaf_errors(p_dev, state[0], floor=None), _leaf_errors(p_dev, state[0])
        j, r = max(range(len(errs)), key=errs.__getitem__), max(range(len(rel)), key=rel.__getitem__)
        if errs[j] > worst["params"]:
            worst.update(params=errs[j], leaf=names[j], step=i)
        if rel[r] > worst["relative"]:
            worst.update(relative=rel[r], relative_leaf=names[r])
        worst["metrics"] = max(worst["metrics"], *(abs(float(m_dev[k]) - float(m_cpu[k])) /
                                                   max(abs(float(m_cpu[k])), 1.0) for k in m_cpu))
    (p_through, _), _ = through(to_device(to_numpy(learner.state), device), device)
    errs = _leaf_errors(p_through, state[0])
    j = max(range(len(errs)), key=errs.__getitem__)
    return {**worst, "steps": steps, "through": errs[j], "through_leaf": names[j]}


def _draws(name: str, batch, device, update):
    """The update's draws for `batch` from a CPU generator seeded 1, on
    `device`: SAC's two normals, TD3's and DDPG's one ([k, mb, act_dim]
    each), DreamerV3's Gumbel noise (`update.draw`)."""
    import torch

    from ray_tpu_torch.rllib.utils.tree import to_device

    gen = torch.Generator().manual_seed(1)
    if name == "dreamerv3":
        return to_device(update.draw(batch, gen), device)
    shape = batch["actions"].shape
    if name == "sac":
        return {n: torch.randn(shape, generator=gen).to(device) for n in ("next", "actor")}
    return torch.randn(shape, generator=gen).to(device)



# ----------------------------------------------------------- rllib_dreamer
# The reference's DreamerV3 tests (`tests/test_rllib_dreamer.py:28-67`): the
# world-model smoke's settings and iterations, and the CartPole bar (mean
# reward, iteration limit) at the defaults; both CartPole-v1, 8 envs,
# fragments of 64, seed 0.
DREAMER_RUNNERS = dict(num_env_runners=0, num_envs_per_env_runner=8, rollout_fragment_length=64)
DREAMER_SMOKE = dict(num_grad_steps=4, batch_size_seqs=16)
DREAMER_SMOKE_ITERS = 6
DREAMER_BAR = (130.0, 120)


@dataclasses.dataclass
class RLlibDreamerSpec:
    """What the rllib_dreamer phase runs: the reference's world-model smoke
    (`smoke_iters` iterations at DREAMER_SMOKE) and its CartPole bar
    (`bar`: mean reward, iteration limit) at the defaults. `device` None:
    the card; the CPU rehearsal (tests/test_torch_chip_smoke.py) passes a
    low bar on "cpu", and `training` there shrinks the bar run's updates
    (the card runs the tests' settings as they are)."""

    bar: tuple = DREAMER_BAR
    smoke_iters: int = DREAMER_SMOKE_ITERS
    training: dict = dataclasses.field(default_factory=dict)
    device: str | None = None


def _dreamer(device, training: dict):
    from ray_tpu_torch.rllib import DreamerV3Config

    return (DreamerV3Config().environment("CartPole-v1").env_runners(**DREAMER_RUNNERS).training(**training)
            .debugging(seed=0).resources(device=device).build())


def _act_graph_against_eager(algo, device, calls: int = 64) -> dict:
    """The local runner's recurrent acting step on the card from its current
    observations and state with the learner's weights: the graphed `act`
    against `act_with_draws` eager given the same Gumbel noise (each from a
    generator seeded 5), bit for bit, and ms a call each way (`calls`
    calls, each from the same arguments)."""
    import torch

    from ray_tpu_torch.rllib.algorithms.dreamerv3 import gumbel
    from ray_tpu_torch.rllib.utils.tree import to_device, tree_leaves

    mod, runner = algo.module, algo._local_runner
    params = to_device(algo._weights, device)
    obs, state = runner._obs_tensor(runner._mobs), runner._state
    n = obs.shape[0]
    out, ms = {}, {}
    with torch.no_grad():
        for how in ("graph", "eager"):
            gen = torch.Generator(device=device).manual_seed(5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                if how == "graph":
                    out[how] = mod.act(params, obs, state, gen)
                else:
                    draws = {"z": gumbel(gen, (n, mod.G, mod.C)), "a": gumbel(gen, (n, mod.act_n))}
                    out[how] = mod.act_with_draws(params, obs, state, draws)
            torch.cuda.synchronize()
            ms[how] = (time.perf_counter() - t0) * 1e3 / calls
    equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(out["graph"]), tree_leaves(out["eager"])))
    return {"graph_ms": ms["graph"], "eager_ms": ms["eager"], "equal": equal}


def phase_rllib_dreamer(launches: dict, spec: RLlibDreamerSpec | None = None) -> None:
    """DreamerV3 on CartPole-v1 through its entry point, the learner and the
    local runner on the card: the reference's world-model smoke (recon
    falls, every loss finite), then its learning bar (settings, seed and
    iteration limit the test's). At the bar run's first update the update
    replaying its CUDA graph (one a gradient step: the world model,
    imagination, the behaviour step, three Adams, the EMA critic and the
    return scale) against the same steps eager on the card, and the
    runner's graphed acting step against the eager one, bit for bit;
    after the bar one update card vs CPU (f32, TF32 off) from the
    learner's last state, given the same Gumbel noise, step by step
    (`_update_card_vs_cpu`), and one profiled update. Records the bar's
    iteration and env steps, sample and update ms (p50), ms a gradient step
    each way, the idle share and the phase wall."""
    import numpy as np
    import torch

    from ray_tpu_torch.rllib.utils.tree import to_device

    spec = spec or RLlibDreamerSpec()
    on_card = spec.device is None
    device = "cuda" if on_card else spec.device
    t_phase = time.perf_counter()
    counts: dict = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        # 1. The world-model smoke (`tests/test_rllib_dreamer.py:28-52`).
        t0 = time.perf_counter()
        algo = _dreamer(spec.device, DREAMER_SMOKE)
        infos = []
        with counted(counts):
            for _ in range(spec.smoke_iters):
                info = algo.train()["info"]["learner"]
                if info:
                    infos.append(info)
        algo.stop()
        recons = [i["recon"] for i in infos]
        finite = all(math.isfinite(i[k]) for i in infos for k in ("wm_loss", "actor_loss", "critic_loss"))
        log(f"rllib_dreamer world-model smoke on {device} ({spec.smoke_iters} iterations, {DREAMER_SMOKE}): recon "
            f"{[round(x, 4) for x in recons]}, wm_loss {[round(i['wm_loss'], 4) for i in infos]}, losses finite "
            f"{finite}; {time.perf_counter() - t0:.1f} s")
        if len(recons) < 3 or not recons[-1] < recons[0] or not finite:
            raise AssertionError(f"rllib_dreamer smoke: world model not learning or a loss not finite: {infos}")

        # 2. The bar (`tests/test_rllib_dreamer.py:55-67`), the graph at the first update.
        bar, max_iters = spec.bar
        t_build = time.perf_counter()
        algo = _dreamer(spec.device, spec.training)
        build_s = time.perf_counter() - t_build
        tap = _LearnerTap(algo)
        learner = algo.learner_group.local_learner
        best, curve, reached, graph, acting = float("-inf"), [], None, None, None
        t0 = time.perf_counter()
        with counted(counts):
            for _ in range(max_iters):
                r = algo.train()
                if graph is None and tap.batch is not None and on_card:
                    draws = _draws("dreamerv3", tap.batch, device, learner._update)
                    graph = _graph_against_eager(learner._update, learner.state, to_device(tap.batch, device),
                                                 draws)
                    acting = _act_graph_against_eager(algo, device)
                    log(f"rllib_dreamer first update (iteration {r['training_iteration']}, {graph['steps']} gradient "
                        f"steps): graphed {graph['graph_ms']:.4f} ms a step, eager {graph['eager_ms']:.4f} ms a step "
                        f"on the card, {graph['eager_ms'] / graph['graph_ms']:.2f}x; replay against eager "
                        f"{'bit for bit' if graph['equal'] else 'NOT equal'}; the acting step graphed "
                        f"{acting['graph_ms']:.4f} ms, eager {acting['eager_ms']:.4f} ms a call, "
                        f"{'bit for bit' if acting['equal'] else 'NOT equal'}; that iteration sample "
                        f"{tap.sample_s[-1] * 1e3:.1f} ms, update {tap.update_s[-1] * 1e3:.1f} ms (the capture "
                        f"included)")
                m = r["episode_reward_mean"]
                curve.append(round(m, 1))
                if np.isfinite(m):
                    best = max(best, m)
                if best >= bar:
                    reached = (r["training_iteration"], r["timesteps_total"])
                    break
        learn_s = time.perf_counter() - t0
        busy = None
        t_prof = time.perf_counter()
        if on_card:
            busy = _profile("rllib_dreamer update (one iteration)", lambda: tap._update(tap.batch))
        prof_s = time.perf_counter() - t_prof
        info = r["info"]["learner"]
        log(f"rllib_dreamer CartPole-v1 on {device}: mean reward by iteration {curve}; "
            + (f"reached {bar} at iteration {reached[0]}, {reached[1]} env steps" if reached else
               f"did NOT reach {bar} within {max_iters} iterations (best {best:.1f})")
            + f"; {learn_s:.1f} s (build {build_s:.1f} s); per iteration sample "
            f"{_LearnerTap.p50_ms(tap.sample_s):.1f} ms, update {_LearnerTap.p50_ms(tap.update_s):.1f} ms (p50 of "
            f"{len(tap.update_s)}); last update's entropy {info.get('entropy', float('nan')):.4f}, ret_scale "
            f"{info.get('ret_scale', float('nan')):.4f}"
            + (f"; device events in one update {busy} (the profile {prof_s:.1f} s)" if busy is not None else ""))
        if reached is None:
            raise AssertionError(f"rllib_dreamer: learning bar missed: best {best:.1f} < {bar} in {max_iters}")

        # 3. One update card vs CPU from the learner's last state, step by step.
        t_check = time.perf_counter()
        with counted(counts):
            e = _update_card_vs_cpu("dreamerv3", algo, learner, tap.batch, device)
        algo.stop()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    log(f"rllib_dreamer one update card vs CPU ({e['steps']} gradient steps from the learner's last state, f32, TF32 "
        f"off, the same Gumbel noise), each step on the card from the CPU's state before it: params worst "
        f"{e['params']:.3e} of 1 + the tensor's largest entry ({e['leaf']}, step {e['step']}; of the largest entry "
        f"alone {e['relative']:.3e}, {e['relative_leaf']}), metrics {e['metrics']:.3e} (tol {RL_TOL}); the "
        f"{e['steps']} steps run through on each device: params {e['through']:.3e} of the largest entry "
        f"({e['through_leaf']}); {time.perf_counter() - t_check:.1f} s")
    if max(e["params"], e["metrics"]) > RL_TOL:
        raise AssertionError(f"rllib_dreamer card vs CPU above {RL_TOL}: params {e['params']}, metrics {e['metrics']}")
    if on_card and not (graph and graph["equal"] and acting["equal"]):
        raise AssertionError(f"rllib_dreamer: graph replay against eager not bit-equal: update {graph}, acting "
                             f"{acting}")
    launches["rllib_dreamer"] = counts
    log(f"rllib_dreamer launches {counts}; phase wall {time.perf_counter() - t_phase:.1f} s")
    if any(counts.get(k, 0) for k in _kernels()):
        raise AssertionError(f"rllib_dreamer: an attention or RMSNorm kernel was launched: {counts}")


# ------------------------------------------------------------ rllib_podracer
@dataclasses.dataclass
class RLlibPodracerSpec:
    """What the rllib_podracer phase runs. Anakin: PPO CartPole-v1 at the
    reference's learning test (`tests/test_podracer_anakin.py:95-108`: 64
    envs x 32 steps, batch 2048, minibatch 512, 4 epochs, lr 2.5e-3, seed
    7, 15 iterations, best mean reward > max(`factor`·first, `floor`) with
    2 and 50), then one
    timed iteration at `wide_envs` envs x 32. Sebulba: the reference test's
    settings (`tests/test_podracer_sebulba.py:21-57`: 2 actors x 32 envs x
    128 steps, minibatch 2048, 2 epochs, lr 1e-3, seed 11), `sebulba_iters`
    iterations, a SIGKILLed actor, one more. `device` None: the card; the
    CPU rehearsal (tests/test_torch_chip_smoke.py) passes a small size and
    a low floor on "cpu"."""

    envs: int = 64
    rollout: int = 32
    minibatch: int = 512
    epochs: int = 4
    lr: float = 2.5e-3
    iters: int = 15
    factor: float = 2.0
    floor: float = 50.0
    wide_envs: int = 4096
    actors: int = 2
    actor_envs: int = 32
    actor_rollout: int = 128
    sebulba_minibatch: int = 2048
    sebulba_epochs: int = 2
    sebulba_lr: float = 1e-3
    sebulba_iters: int = 2
    device: str | None = None


def _anakin(spec: RLlibPodracerSpec, device, envs: int):
    from ray_tpu_torch.rllib import PPOConfig

    return (PPOConfig().environment("CartPole-v1")
            .training(train_batch_size=envs * spec.rollout, minibatch_size=spec.minibatch, num_epochs=spec.epochs,
                      lr=spec.lr)
            .debugging(seed=7).podracer("anakin", num_envs=envs, rollout_len=spec.rollout)
            .resources(device=device).build())


def _sebulba(spec: RLlibPodracerSpec, device):
    from ray_tpu_torch.rllib import PPOConfig

    return (PPOConfig().environment("CartPole-v1")
            .training(train_batch_size=spec.actors * spec.actor_envs * spec.actor_rollout,
                      minibatch_size=spec.sebulba_minibatch, num_epochs=spec.sebulba_epochs, lr=spec.sebulba_lr)
            .debugging(seed=11)
            .podracer("sebulba", num_actors=spec.actors, envs_per_actor=spec.actor_envs,
                      rollout_len=spec.actor_rollout, min_actors=1, max_restarts=3)
            .resources(device=device).build())


def _host_ms(fn, device: str, iters: int = 5) -> float:
    """Host ms a call of `fn`, the device drained before and after (one
    warm call first)."""
    import torch

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def _pair_errors(p_dev, p_cpu, m_dev: dict, m_cpu: dict) -> dict:
    """Params and metrics of one update card vs CPU in the RL phases'
    measure (`_update_card_vs_cpu`): each param tensor's worst |d| over 1 +
    its largest entry, each metric's over max(|cpu|, 1); and beside them
    over the largest entry alone and over |cpu| alone, with the metric that
    is worst so."""
    rel = {k: abs(float(m_dev[k]) - float(m_cpu[k])) / max(abs(float(m_cpu[k])), 1e-30) for k in m_cpu}
    worst = max(rel, key=rel.get)
    return {"params": max(_leaf_errors(p_dev, p_cpu, floor=None)), "params_rel": max(_leaf_errors(p_dev, p_cpu)),
            "metrics": max(abs(float(m_dev[k]) - float(m_cpu[k])) / max(abs(float(m_cpu[k])), 1.0) for k in m_cpu),
            "metrics_rel": rel[worst], "worst": f"{worst} {float(m_cpu[worst]):.4e}"}


def _pair_line(e: dict) -> str:
    return (f"params worst {e['params']:.3e} of 1 + each tensor's largest entry ({e['params_rel']:.3e} of the "
            f"largest alone), metrics {e['metrics']:.3e} of max(|cpu|, 1) (of |cpu| alone {e['metrics_rel']:.3e}, "
            f"{e['worst']}) (tol {RL_TOL})")


def _anakin_card_vs_cpu(drv, device: str) -> dict:
    """One fused step from the driver's state on the card and on the CPU
    (f32), given the same draws and permutations (drawn on the CPU from a
    generator seeded 3): the trajectories' actions and observations, and
    params and metrics after the update (`_pair_errors`)."""
    import torch

    from ray_tpu_torch.rllib.podracer.anakin import make_anakin_step
    from ray_tpu_torch.rllib.utils.tree import to_device

    gen = torch.Generator().manual_seed(3)
    draws = drv._step.draw(gen, drv.num_envs)
    perms = drv._step.perms(gen, drv.rollout_len * drv.num_envs)
    host = to_device((drv._state, drv._env_state), "cpu")
    out = {}
    for dev in (device, "cpu"):
        opt, update = drv.algo._podracer_update_factory()
        step = make_anakin_step(drv.env, drv.module, update, drv.rollout_len)
        state, env_state = to_device(host, dev)
        d, p = to_device(draws, dev), perms.to(dev)
        _, traj = step.rollout(state[0], env_state, d)
        (params, _), _, metrics, _ = step.with_draws(state, env_state, d, p)
        out[dev] = (traj, params, metrics)
    (t_dev, p_dev, m_dev), (t_cpu, p_cpu, m_cpu) = out[device], out["cpu"]
    flips = int((t_dev["actions"].cpu() != t_cpu["actions"]).sum())
    return {"flips": flips, "obs": max(_leaf_errors(t_dev["obs"], t_cpu["obs"], floor=None)),
            **_pair_errors(p_dev, p_cpu, m_dev, m_cpu)}


def phase_rllib_podracer(launches: dict, spec: RLlibPodracerSpec | None = None) -> None:
    """The podracer planes through PPO's entry point. Anakin on the card:
    the rollout's CUDA graph against the same rollout eager given the same
    draws (bit for bit) before the first iteration, the reference test's
    learning bar, one fused step card vs CPU (f32, TF32 off, the same
    draws and permutations), one profiled step, the fused step split into
    rollout and update ms, env steps/s, and one timed iteration at
    `wide_envs` envs. Sebulba with the learner in a GPU worker, its
    cluster booted by the plane: the reference test's iterations with the
    block transport's stats, a SIGKILLed actor survived inside one train()
    with the step count continuous, one more iteration, and the learner's
    update card vs CPU given the same batch and permutations. Records the
    build (cluster + GPU worker boot) s, the learner step ms, the restart s
    and the phase wall."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib.utils.tree import tree_leaves

    spec = spec or RLlibPodracerSpec()
    on_card = spec.device is None
    device = "cuda" if on_card else spec.device
    t_phase = time.perf_counter()
    counts: dict = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        # 1. Anakin: the rollout graph against eager, then the learning bar
        # (`tests/test_podracer_anakin.py:95-108`).
        t0 = time.perf_counter()
        algo = _anakin(spec, spec.device, spec.envs)
        drv = algo._podracer
        build_s = time.perf_counter() - t0
        params, env_state = drv._state[0], drv._env_state
        draws = drv._step.draw(torch.Generator(device=device).manual_seed(5), spec.envs)
        graphed = drv._step.rollout(params, env_state, draws)
        eager = drv._step.rollout_eager(params, env_state, draws)
        replay_equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(graphed), tree_leaves(eager)))
        roll_ms = {"graph": _host_ms(lambda: drv._step.rollout(params, env_state, draws), device),
                   "eager": _host_ms(lambda: drv._step.rollout_eager(params, env_state, draws), device)}
        log(f"rllib_podracer anakin rollout ({spec.rollout} steps x {spec.envs} envs) from the first iteration's "
            f"state: {'one CUDA graph' if on_card else 'eager (the CPU)'} against eager given the same draws "
            f"{'bit for bit' if replay_equal else 'NOT equal'}; {roll_ms['graph']:.3f} ms against "
            f"{roll_ms['eager']:.3f} ms a rollout (build {build_s:.2f} s)")
        curve, step_s = [], []
        t0 = time.perf_counter()
        with counted(counts):
            for _ in range(spec.iters):
                r = algo.train()
                curve.append(r["episode_reward_mean"])
                step_s.append(r["info"]["fused_step_seconds"])
        learn_s = time.perf_counter() - t0
        first, best = curve[0], max(curve)
        bar = max(spec.factor * first, spec.floor)
        steps = r["timesteps_total"]
        # The fused step split into its rollout (one graph) and its update
        # (GAE, then each minibatch step a graph), from the last state.
        state, env_state = drv._state, drv._env_state
        gen = torch.Generator(device=device).manual_seed(6)
        draws = drv._step.draw(gen, spec.envs)
        perms = drv._step.perms(gen, spec.rollout * spec.envs)
        traj = drv._step.rollout(state[0], env_state, draws)[1]
        batch = {k: traj[k] for k in ("obs", "actions", "logp", "values", "rewards", "dones", "last_obs")}
        _, update = algo._podracer_update_factory()
        split = {"rollout": _host_ms(lambda: drv._step.rollout(state[0], env_state, draws), device),
                 "update": _host_ms(lambda: update.with_perms(state, batch, perms), device),
                 "fused": _host_ms(lambda: drv._step.with_draws(state, env_state, draws, perms), device)}
        prof: dict = {}
        if on_card:
            _profile("rllib_podracer anakin fused step (one iteration)",
                     lambda: drv._step.with_draws(state, env_state, draws, perms), stats=prof)
        log(f"rllib_podracer anakin PPO CartPole-v1 on {device} ({spec.envs} envs x {spec.rollout}, minibatch "
            f"{spec.minibatch}, {spec.epochs} epochs, lr {spec.lr}, seed 7): mean reward by iteration "
            f"{[round(x, 1) for x in curve]}; first {first:.1f}, best {best:.1f} (bar > {bar:.1f}); {steps} env steps "
            f"in {learn_s:.2f} s, {steps / learn_s:.1f} env steps/s; fused step p50 "
            f"{_LearnerTap.p50_ms(step_s):.3f} ms (the read-back included); from the last state: rollout "
            f"{split['rollout']:.3f} ms, update {split['update']:.3f} ms, fused {split['fused']:.3f} ms"
            + (f"; profiled step: busy {prof['busy_ms']:.3f} ms of {prof['window_ms']:.3f}, idle share "
               f"{prof['idle']:.3f}, {prof['events']} device events" if prof else ""))
        if not best > bar:
            raise AssertionError(f"rllib_podracer anakin: learning bar missed: first {first:.1f}, best {best:.1f}")
        if not replay_equal:
            raise AssertionError("rllib_podracer anakin: the rollout's graph is not its eager rollout bit for bit")
        t_check = time.perf_counter()
        e = _anakin_card_vs_cpu(drv, device)
        log(f"rllib_podracer anakin one fused step card vs CPU from the last state (f32, TF32 off, the same draws "
            f"and permutations): actions differing {e['flips']} of {spec.rollout * spec.envs}; observations "
            f"{e['obs']:.3e} of 1 + the largest entry; {_pair_line(e)}; {time.perf_counter() - t_check:.1f} s")
        if e["flips"] or max(e["params"], e["metrics"]) > RL_TOL:
            raise AssertionError(f"rllib_podracer anakin card vs CPU: {e} (tol {RL_TOL})")
        algo.stop()
        del algo, drv

        # 2. Anakin at `wide_envs` envs: one timed iteration after one that
        # captures the graphs.
        wide = _anakin(spec, spec.device, spec.wide_envs)
        with counted(counts):
            w1 = wide.train()
            w2 = wide.train()
        wdrv = wide._podracer
        wdraws = wdrv._step.draw(torch.Generator(device=device).manual_seed(7), spec.wide_envs)
        wroll = _host_ms(lambda: wdrv._step.rollout(wdrv._state[0], wdrv._env_state, wdraws), device, iters=3)
        wsteps = w2["num_env_steps_sampled_this_iter"]
        log(f"rllib_podracer anakin at {spec.wide_envs} envs x {spec.rollout}: {wsteps} env steps, fused step "
            f"{w2['info']['fused_step_seconds'] * 1e3:.2f} ms ({wsteps / w2['info']['fused_step_seconds']:.0f} env "
            f"steps/s; the first, capturing, {w1['info']['fused_step_seconds'] * 1e3:.1f} ms), rollout "
            f"{wroll:.3f} ms ({wsteps / wroll * 1e3:.0f} env steps/s)")
        wide.stop()
        del wide, wdrv

        # 3. Sebulba, its cluster booted by the plane (`tests/test_podracer_sebulba.py:21-57`).
        if rt.is_initialized():
            raise AssertionError("rllib_podracer: a runtime is up before Sebulba boots its own")
        t0 = time.perf_counter()
        algo = _sebulba(spec, spec.device)
        sebulba_build_s = time.perf_counter() - t0
        _sebulba_checks(algo, spec, device, sebulba_build_s, counts)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    launches["rllib_podracer"] = counts
    log(f"rllib_podracer launches (driver side; the Sebulba learner's process is not read) {counts}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    if any(counts.get(k, 0) for k in _kernels()):
        raise AssertionError(f"rllib_podracer: an attention or RMSNorm kernel was launched: {counts}")


def _sebulba_checks(algo, spec: RLlibPodracerSpec, device: str, build_s: float, counts: dict) -> None:
    """The Sebulba part of the rllib_podracer phase on a built algorithm
    (its cluster up): its iterations, the kill, one more, the learner's
    update card vs CPU; the runtime shut down after."""
    import pickle

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api
    from ray_tpu_torch.rllib.env.env_runner import EnvRunner
    from ray_tpu_torch.rllib.utils.tree import to_device

    backend = api._global_runtime().backend
    session_dir, controller = backend.session_dir, backend._controller_proc.pid
    try:
        drv = algo._podracer
        where = rt.get(drv.gang.learner.device_name.remote(), timeout=60)
        per_actor = spec.actor_envs * spec.actor_rollout
        res = []
        with counted(counts):
            for _ in range(spec.sebulba_iters):
                res.append(algo.train())
        stats = drv.transport_stats
        totals = [x["timesteps_total"] for x in res]
        arena = all(a["pub_arena"] >= 1 and a["pub_inline"] == 0 for a in stats["actors"])
        lstats = stats["learner"]
        fetched = lstats["fetch_local"] + lstats["fetch_span"] >= spec.actors and lstats["fetch_inline"] == 0
        # SIGKILL one actor: the same train() recovers and retries.
        sup = drv._supervisor
        victim = rt.get(drv.gang.actors[0].pid.remote(), timeout=30)
        t_kill = time.perf_counter()
        os.kill(victim, 9)
        with counted(counts):
            r2 = algo.train()
        restart_s = time.perf_counter() - t_kill
        n_after = r2["info"]["num_actors"]
        delta = r2["timesteps_total"] - res[-1]["timesteps_total"]
        with counted(counts):
            r3 = algo.train()
        after = all(a["pub_arena"] >= 1 for a in drv.transport_stats["actors"])
        learner_ms = [x["info"]["learner_step_seconds"] * 1e3 for x in res + [r2, r3]]
        log(f"rllib_podracer sebulba ({spec.actors} CPU actors x {spec.actor_envs} envs x {spec.actor_rollout}, the "
            f"learner on {where}; minibatch {spec.sebulba_minibatch}, {spec.sebulba_epochs} epochs, lr "
            f"{spec.sebulba_lr}, seed 11): build {build_s:.2f} s (the cluster's boot and the gang's spawn, the "
            f"learner's worker included); env steps {totals}; transport stats {stats}; actors on the arena "
            f"{arena}, learner fetches {fetched}; SIGKILL of an actor: the same train() returned after "
            f"{restart_s:.2f} s with attempts {sup.attempts}, {n_after} actors, the step count +{delta} (one "
            f"iteration: {per_actor * n_after}); one more iteration to {r3['timesteps_total']} (arena {after}); "
            f"learner step ms {[round(x, 2) for x in learner_ms]}; iteration s "
            f"{[round(x['time_this_iter_s'], 3) for x in res + [r2, r3]]}")
        if totals != [per_actor * spec.actors * (i + 1) for i in range(spec.sebulba_iters)] or not arena \
                or not fetched:
            raise AssertionError(f"rllib_podracer sebulba: steps {totals}, transport {stats}")
        if where != device:
            raise AssertionError(f"rllib_podracer sebulba: the learner runs on {where}, not {device}")
        if sup.attempts != 1 or not 1 <= n_after <= spec.actors or delta != per_actor * n_after or not after \
                or not r3["timesteps_total"] > r2["timesteps_total"] \
                or not math.isfinite(r3["info"]["learner"]["total_loss"]):
            raise AssertionError(f"rllib_podracer sebulba recovery: attempts {sup.attempts}, actors {n_after}, "
                                 f"steps +{delta}, arena after {after}, {r3['timesteps_total']}")

        # 4. The learner's update card vs CPU: two actors' fragments (CPU
        # runners as the actors run them, from the learner's weights),
        # concatenated as the learner does, the learner's state and the same
        # permutations.
        t_check = time.perf_counter()
        frags = [EnvRunner(env_name="CartPole-v1", num_envs=spec.actor_envs, module=algo.module,
                           rollout_len=spec.actor_rollout, seed=100 + i, device="cpu").sample(drv.get_weights())
                 for i in range(spec.actors)]
        batch = {k: np.concatenate([f[k] for f in frags], axis=0 if k == "last_obs" else 1)
                 for k in frags[0] if not k.startswith("episode_")}
        params, opt_state, _ = pickle.loads(drv.save_state())
        _, update = algo._podracer_update_factory()
        perms = update.perms(torch.Generator().manual_seed(4), spec.actors * per_actor)
        outs = {}
        for dev in (device, "cpu"):
            outs[dev] = update.with_perms(to_device((params, opt_state), dev), to_device(batch, dev), perms.to(dev))
        (p_dev, _), m_dev = outs[device]
        (p_cpu, _), m_cpu = outs["cpu"]
        e = _pair_errors(p_dev, p_cpu, m_dev, m_cpu)
        log(f"rllib_podracer sebulba the learner's update card vs CPU (its state after the last iteration, "
            f"{spec.actors} fragments, f32, TF32 off): {_pair_line(e)}; {time.perf_counter() - t_check:.1f} s")
        if max(e["params"], e["metrics"]) > RL_TOL:
            raise AssertionError(f"rllib_podracer sebulba card vs CPU: {e} (tol {RL_TOL})")
        algo.stop()
    finally:
        left = _end_session(controller, session_dir)
    if left:
        raise AssertionError(f"rllib_podracer: processes outlived shutdown (killed): {left}")


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


def device_events(prof, device_type) -> list:
    """(name, start µs, end µs) of each event of a finished profile on
    `device_type`, user annotations left out (e.g. "Optimizer.step#AdamW.step",
    which also appears on the device timeline, spans idle gaps and is no
    kernel). Read from the profiler's raw results: the events, names (as
    `StringTable` demangles them) and times from the trace's start that
    `prof.events()` gives, without the Python tree it builds over every
    event, CPU ones included (≈90 µs an event)."""
    import torch

    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    out = []
    for e in result.events():
        if e.device_type() == device_type and not e.is_user_annotation():
            name = e.name()
            out.append((torch._C._demangle(name) if len(name) > 1 else name,
                        (e.start_ns() - t0) / 1000, (e.end_ns() - t0) / 1000))
    return out


def _profile(label: str, fn, stats: dict | None = None):
    """Device busy time, idle share and the top kernels of one call of fn,
    from torch.profiler (the profiler's own overhead lengthens host time).
    Returns the number of device events (None when none were recorded);
    `stats`, when given, gets busy_ms, window_ms, idle and events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for name, start, end in device_events(prof, torch.autograd.DeviceType.CUDA):
        spans.append((start, end))
        by_name[name] = by_name.get(name, 0.0) + (end - start)
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
    if stats is not None:
        stats.update(busy_ms=busy / 1e3, window_ms=window / 1e3, idle=1 - busy / window, events=len(spans))
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

    walls: dict = {}  # phase -> its seconds

    @contextlib.contextmanager
    def wall(name):
        t0 = time.perf_counter()
        yield
        walls[name] = round(time.perf_counter() - t0, 1)

    if "build" in phases or "kernels" in phases:
        with wall("build"):
            build.library()
            log(f"build: {build.build_seconds:.1f} s into {build.build_dir()}")
            check_build(build)

    results: dict = {}
    if "kernels" in phases:
        with wall("kernels"):
            phase_kernels(results)
    if "parity" in phases:
        with wall("parity"):
            phase_parity()
    launches: dict = {}  # path -> kernel -> launches in that path's run
    if "train_parity" in phases:
        with wall("train_parity"):
            phase_train_parity(launches)
    if "train" in phases:
        with wall("train"):
            phase_train(launches)
    trained = None
    if "trainer" in phases:
        with wall("trainer"):
            trained = phase_trainer(launches)
    if "mpmd" in phases:
        with wall("mpmd"):
            phase_mpmd(launches, trained)
    if "data" in phases:
        with wall("data"):
            phase_data(launches, trained)
    if "gbdt" in phases:
        with wall("gbdt"):
            phase_gbdt(launches)
    if "rllib" in phases:
        with wall("rllib"):
            phase_rllib(launches)
    if "rllib_algos" in phases:
        with wall("rllib_algos"):
            phase_rllib_algos(launches)
    if "rllib_algos_ii" in phases:
        with wall("rllib_algos_ii"):
            phase_rllib_algos_ii(launches)
    if "rllib_dreamer" in phases:
        with wall("rllib_dreamer"):
            phase_rllib_dreamer(launches)
    if "rllib_podracer" in phases:
        with wall("rllib_podracer"):
            phase_rllib_podracer(launches)
    if "parallel" in phases:
        with wall("parallel"):
            phase_parallel(launches)
    generated = served = None
    if "generate" in phases or "engine" in phases:
        with wall("llama-7b params"):
            cfg, params = _llama_params()
        if "generate" in phases:
            with wall("generate"):
                generated = phase_generate(cfg, params, launches)
        if "engine" in phases:
            with wall("engine"):
                served = phase_engine(cfg, params, launches)
        del params  # the runtime phase's actor loads its own copy
        torch.cuda.empty_cache()
    if "runtime" in phases:
        with wall("runtime"):
            if generated is None:
                ap.error("the runtime phase holds its actor's tokens against the generate phase's: run both")
            log(f"driver device memory before the runtime phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                "allocated")
            phase_runtime(generated, launches)
    if "serve" in phases:
        with wall("serve"):
            if served is None:
                ap.error("the serve phase holds its replicas' tokens against the engine phase's: run both")
            phase_serve(served, launches)
    log(f"wall time {time.perf_counter() - t_start:.1f} s; by phase {walls}")

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

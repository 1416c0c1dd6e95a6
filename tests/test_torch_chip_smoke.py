"""`chip_smoke.py`'s build guard, checked on the CPU against ptxas and
cuobjdump output of the bf16 flash kernels (forward, backward dQ and
dK/dV): a build whose wgmma products ptxas serialised, that spills, or that
lacks an instantiation, fails; a pipelined one passes. And the runtime
phase's check that its processes ended after shutdown, which looks at this
run's processes only."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke

FN = "_ZN45_GLOBAL__N__a66d6197_12_flash_fwd_cu_e1dd8ece14flash_fwd_bf16ILi128EEEv14CUtensorMap_stS1_S1_PtPfiiiifiii"
BWD_FN = ("_ZN45_GLOBAL__N__0f3c1a2b_12_flash_bwd_cu_7d41e9a017flash_bwd_dq_bf16ILi64EEEv14CUtensorMap_stS1_S1_"
          "S1_S1_S1_PtPKfPfNS_5TilesEiiiifiii")
DKV_FN = ("_ZN45_GLOBAL__N__0f3c1a2b_12_flash_bwd_cu_7d41e9a018flash_bwd_dkv_bf16ILi256EEEv14CUtensorMap_stS1_"
          "S1_S1_S1_S1_PtS2_PKfS4_NS_5TilesEiiiifiii")
NOTE = ("ptxas info    : (C7513) Potential Performance Loss: wgmma.mma_async instructions are serialized "
        "due to non wgmma instructions defining input registers of a wgmma between start and end of the "
        "pipeline stage")


def _report(spill_bytes=0, note=None, fn=FN):
    lines = [f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'",
             f"ptxas info    : Function properties for {fn}",
             f"    0 bytes stack frame, {spill_bytes} bytes spill stores, {spill_bytes} bytes spill loads",
             "ptxas info    : Used 168 registers, used 16 barriers"]
    if note is not None:
        lines.append(note)
    return "\n".join(lines)


@pytest.mark.parametrize("note", [
    f"{NOTE} in the function '{FN}'",
    NOTE + " ",                            # the note without its function on the line
    "ptxas info    : (C7513) Potential Performance Loss: wgmma.mma_async instructions are serialized",
])
def test_serialised_wgmma_note_is_found_with_or_without_a_function(note):
    report = _report(note=note)
    assert chip_smoke.serialised_wgmma(report) == [note]
    assert chip_smoke.spill_stores(report) == {FN: 0}


def test_clean_report_and_spills():
    assert chip_smoke.serialised_wgmma(_report()) == []
    assert chip_smoke.spill_stores(_report(spill_bytes=20)) == {FN: 20}


def test_backward_spills_and_notes_are_found():
    """The backward instantiations are keyed by function name like the
    forward's; a C7513 note after a backward function, with no name on its
    line, is found."""
    report = "\n".join([_report(fn=FN), _report(spill_bytes=8, fn=BWD_FN), _report(fn=DKV_FN, note=NOTE)])
    assert chip_smoke.spill_stores(report) == {FN: 0, BWD_FN: 8, DKV_FN: 0}
    assert chip_smoke.serialised_wgmma(report) == [NOTE]
    assert [chip_smoke.instantiation(f) for f in (FN, BWD_FN, DKV_FN)] == [
        "flash_fwd_bf16 D=128", "flash_bwd_dq_bf16 D=64", "flash_bwd_dkv_bf16 D=256"]
    assert chip_smoke.instantiation("_Z10rmsnorm_fwdv") is None


def test_every_instantiation_is_required():
    everything = [f"{k} D={d}" for k in chip_smoke.BF16_FLASH for d in chip_smoke.HEAD_DIMS]
    assert len(everything) == 12 and chip_smoke.missing_instantiations(everything) == []
    assert chip_smoke.missing_instantiations(everything[:-1]) == ["flash_bwd_dkv_bf16 D=256"]


HGMMA = "        /*1680*/                   HGMMA.64x128x16.F32.BF16 R88, gdesc[UR8], R88, gsb0 ;"
DEPBAR = "        /*17a0*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;"
ARRIVE = "        /*15c0*/                   WARPGROUP.ARRIVE ;"
TMA = "        /*a260*/                   UTMALDG.4D [UR8], [UR24] ;"
STORE = "        /*b000*/                   UTMASTG.4D [UR4], [UR6] ;"


def _sass(body, fn=FN):
    return "\n".join([f"\t\tFunction : {fn}", *body])


def test_pipelined_sass_passes():
    body = [TMA] * 6 + [ARRIVE] + [HGMMA] * 8 + [DEPBAR] + [ARRIVE] + [HGMMA] * 16 + [DEPBAR] * 2 + [STORE] * 2
    bwd = [TMA] * 4 + [ARRIVE] + [HGMMA] * 16 + [DEPBAR] + [HGMMA] * 8 + [DEPBAR] * 2 + [STORE]
    sass = "\n".join([_sass(body), "\t\tFunction : _Z10rmsnorm_fwdv", HGMMA, _sass(bwd, BWD_FN)])
    counts = chip_smoke.sass_counts(sass)
    assert counts == {"flash_fwd_bf16 D=128": {"HGMMA": 24, "UTMALDG": 6, "UTMASTG": 2, "DEPBAR": 3},
                      "flash_bwd_dq_bf16 D=64": {"HGMMA": 24, "UTMALDG": 4, "UTMASTG": 1, "DEPBAR": 3}}
    chip_smoke.check_sass(counts)


@pytest.mark.parametrize("case", ["serialised", "no HGMMA", "no UTMALDG", "no flash forward",
                                  "serialised backward"])
def test_bad_sass_fails(case):
    body = {
        # ptxas's serialisation: a wait after every product
        "serialised": [TMA] * 6 + [ARRIVE, HGMMA, DEPBAR] * 32,
        "no HGMMA": [TMA] * 6 + [DEPBAR],
        "no UTMALDG": [ARRIVE] + [HGMMA] * 8 + [DEPBAR],
        "no flash forward": [],
        # a pipelined forward beside a backward whose products are serialised
        "serialised backward": [TMA] * 6 + [ARRIVE] + [HGMMA] * 8 + [DEPBAR],
    }[case]
    fn = "_Z10rmsnorm_fwdv" if case == "no flash forward" else FN
    sass = _sass(body, fn)
    if case == "serialised backward":
        sass += "\n" + _sass([TMA] * 4 + [ARRIVE, HGMMA, DEPBAR] * 24, DKV_FN)
    counts = chip_smoke.sass_counts(sass)
    with pytest.raises(AssertionError):
        chip_smoke.check_sass(counts)


RMS_REGS = "_ZN43_GLOBAL__N__ca1deaa9_10_rmsnorm_cu_f7e8034512rmsnorm_regsILi2ELi4ELi1EEEvPKhS2_PhiixfNS_9RmsLaunchE"
RMS_ROWS = "_ZN43_GLOBAL__N__ca1deaa9_10_rmsnorm_cu_f7e8034512rmsnorm_rowsILi4ELi2ELb1EEEvPKhS2_Phiixf"


def _rmsnorm_fns(leave_out=()):
    """A mangled name for every RMSNorm instantiation but `leave_out`."""
    types = {"bf16": "2", "f32": "4"}
    fns = []
    for name in chip_smoke.rmsnorm_expected():
        if name in leave_out:
            continue
        kernel, x, w, kind = name.split()
        tail = f"Li{kind[3:]}E" if kind.startswith("NV=") else f"Lb{int(kind == 'vector')}E"
        fns.append(f"_ZN43_GLOBAL__N__ca1deaa9_10_rmsnorm_cu_f7e8034512{kernel}ILi{types[x[2:]]}ELi{types[w[2:]]}E"
                   f"{tail}EvPKh")
    return fns


@pytest.mark.parametrize("case", ["clean", "spill", "missing"])
def test_rmsnorm_build_guard(case):
    """RMSNorm instantiations are named by kernel, dtypes and NV (or load
    width); a spill or a missing instantiation in the ptxas report fails."""
    assert [chip_smoke.rmsnorm_instantiation(f) for f in (RMS_REGS, RMS_ROWS, FN)] == [
        "rmsnorm_regs x=bf16 w=f32 NV=1", "rmsnorm_rows x=f32 w=bf16 vector", None]
    assert len(chip_smoke.rmsnorm_expected()) == 16
    fns = _rmsnorm_fns(leave_out=("rmsnorm_rows x=f32 w=f32 scalar",) if case == "missing" else ())
    report = "\n".join([_report(fn=FN)] + [_report(spill_bytes=8 if case == "spill" and fn == fns[3] else 0, fn=fn)
                                            for fn in fns])
    spills = chip_smoke.spill_stores(report)
    assert len(spills) == len(fns) + 1 and spills[FN] == 0
    assert chip_smoke.missing_rmsnorm(spills) == (["rmsnorm_rows x=f32 w=f32 scalar"] if case == "missing" else [])
    assert any(spills.values()) == (case == "spill")


def test_session_processes_are_this_runs_only(tmp_path):
    """After shutdown the runtime phase waits for, and kills, the processes
    of its own session only: those it saw among its descendants (still the
    same process) and those whose environment names its session dir, not
    another session's (a parent checkout's smoke or a test's cluster)."""
    ours, other = str(tmp_path / "s1"), str(tmp_path / "s10")
    sleep = [sys.executable, "-c", "import time; time.sleep(60)"]
    procs = {name: subprocess.Popen(sleep, env={**os.environ, "RAY_TPU_SESSION_DIR": d})
             for name, d in (("in_session", ours), ("other_session", other), ("seen", other))}
    try:
        known = chip_smoke._descendants(os.getpid())
        pids = {name: p.pid for name, p in procs.items()}
        assert set(pids.values()) <= set(known)
        seen = {pids["seen"]: known[pids["seen"]]}
        found = {pid for pid, _ in chip_smoke._session_processes(seen, ours)}
        assert found == {pids["in_session"], pids["seen"]}
        # A pid that was seen but now names another process (reused) is not ours.
        assert {pid for pid, _ in chip_smoke._session_processes({pids["other_session"]: "0"}, "")} == set()
        procs["in_session"].kill()
        procs["in_session"].wait()
        assert {pid for pid, _ in chip_smoke._session_processes(seen, ours)} == {pids["seen"]}
    finally:
        for p in procs.values():
            p.kill()
            p.wait()


TINY = dict(vocab_size=64, n_layers=2, d_model=48, n_heads=3, d_head=16, d_mlp=96, max_seq=256,
            attn_impl="ref", remat=False, pos="rotary", rotary_dim=16, norm="rmsnorm",
            activation="swiglu", dtype="float32")


def test_serve_phase_is_after_runtime():
    assert chip_smoke.PHASES.index("serve") == chip_smoke.PHASES.index("runtime") + 1
    assert chip_smoke.PHASES[-1] == "serve"


def test_serve_phase_rehearsal_on_the_cpu():
    """The serve phase's control flow, rehearsed on the CPU with a tiny model
    (every kernel's plain version, so no launch is counted): a cluster with
    one advertised GPU and no card, the colocated replica held to a fresh
    engine's lone-request tokens through the handle and over HTTP, the
    streamed burst, the f32 disaggregated pair held exactly to colocated
    decoding, the full-width pair's imports, and the session's processes
    gone after shutdown."""
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.serve.engine import EngineOptions, InferenceEngine

    options = {"num_blocks": 64, "block_size": 4, "max_num_seqs": 4}
    spec = chip_smoke.ServeSpec(model="gpt2-small", full=TINY, parity={**TINY, "n_layers": 1},
                                engine_options=options, parity_options=options,
                                init={"num_cpus": 4, "num_gpus": 1}, device="cpu")
    rng = np.random.default_rng(5)
    requests = [rng.integers(0, 64, n).tolist() for n in (9, 17, 12, 21, 30, 8)]
    n = 6

    def engine():
        return InferenceEngine(GPTConfig(**TINY), None, EngineOptions(**options, seed=0), device="cpu")

    batched = engine()
    rids = [batched.submit(p, n) for p in requests]
    chip_smoke._drain(batched)
    lone = chip_smoke._lone_runs(engine(), requests[:2], n)
    served = {"requests": requests, "tokens": [list(batched.stream(r)) for r in rids], "max_tokens": n,
              "tokens_per_s": 1.0, "lone_prompts": requests[:2], "lone_tokens": [t for t, _ in lone]}
    launches = {}
    chip_smoke.phase_serve(served, launches, spec)
    assert set(launches["serve"]) == set(chip_smoke._kernels()) and not any(launches["serve"].values())


def test_trainer_phase_is_after_train():
    assert chip_smoke.PHASES.index("trainer") > chip_smoke.PHASES.index("train")


TRAINER_GPT = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_head=16, d_mlp=64, max_seq=16)
TRAINER_LLAMA = {**TINY, "attn_impl": "flash", "remat": True, "remat_policy": "attn", "max_seq": 16}


def test_trainer_phase_rehearsal_on_the_cpu():
    """The trainer phase's control flow, rehearsed on the CPU with tiny
    models in a cluster with one advertised GPU and no card (every kernel's
    plain version, so no launch is counted; one torch thread, so the
    driver's and the worker's products agree bit for bit): the trainer's
    steps equal the in-process ones, the pipeline step and its parity, the
    worker SIGKILLed after step 3 and the run resumed from the step-2
    commit with the unkilled losses, and the session's processes gone."""
    spec = chip_smoke.TrainerSpec(
        step=("gpt2-small", TRAINER_GPT, (2, 16)), warm=1, timed=2,
        pipe=("llama-7b", TRAINER_LLAMA, (4, 16)), pipe_micro=2, pipe_steps=3,
        parity=("llama-7b", TRAINER_LLAMA, (2, 16)), parity_micro=2,
        kill=("gpt2-small", TRAINER_GPT, (2, 16)), kill_steps=6, save_every=2, kill_after=3,
        init={"num_cpus": 4, "num_gpus": 1}, device="cpu", threads=1)
    threads = torch.get_num_threads()
    launches = {}
    try:
        chip_smoke.phase_trainer(launches, spec)
    finally:
        torch.set_num_threads(threads)
    assert set(launches["trainer"]) == set(chip_smoke._kernels()) and not any(launches["trainer"].values())


def test_mpmd_phase_is_after_trainer():
    assert chip_smoke.PHASES.index("mpmd") == chip_smoke.PHASES.index("trainer") + 1


def test_mpmd_launch_prediction():
    """The launches the mpmd phase predicts per step, from the schedule:
    at llama-7b widths (4 layers, 2 stages, M=4, remat "attn") 24 flash
    forwards (stage 0 runs its forward twice per microbatch), 16 dQ and 16
    dK/dV, 84 RMSNorms; interleaved (v=2) 28 / 16 / 16 / 92; gpt2 (LayerNorm)
    at dp=2, M=2: 24 / 16 / 16 / 0."""
    from ray_tpu_torch.models.gpt import gpt2_large, llama_7b

    llama = llama_7b(n_layers=4, remat=True, remat_policy="attn")
    assert chip_smoke.mpmd_launches(llama, 2, 1, 4, 1) == {"flash_fwd": 24, "flash_bwd_dq": 16,
                                                           "flash_bwd_dkv": 16, "rmsnorm": 84}
    assert chip_smoke.mpmd_launches(llama, 2, 2, 4, 1) == {"flash_fwd": 28, "flash_bwd_dq": 16,
                                                           "flash_bwd_dkv": 16, "rmsnorm": 92}
    assert chip_smoke.mpmd_launches(gpt2_large(n_layers=4, remat=True, remat_policy="attn"), 2, 1, 2, 2) == {
        "flash_fwd": 24, "flash_bwd_dq": 16, "flash_bwd_dkv": 16, "rmsnorm": 0}


def test_mpmd_phase_rehearsal_on_the_cpu():
    """The mpmd phase's control flow, rehearsed on the CPU with tiny models
    in a cluster with one advertised GPU and no card (every kernel's plain
    version, so no launch is counted): the 1F1B run and its interleaved
    twin with equal losses, the card-vs-CPU parity (both sides on the CPU),
    and the ZeRO run at two stages x dp=2 whose stage-1 replica is
    SIGKILLed after step 3, resumed at the step-2 commit with the unkilled
    run's losses; the session's processes gone after shutdown."""
    spec = chip_smoke.MPMDSpec(
        pipe=("llama-7b", {**TRAINER_LLAMA, "n_layers": 4}, (4, 16)), micro=2, warm=1, timed=2,
        parity=("llama-7b", TRAINER_LLAMA, (2, 16)),
        kill=("gpt2-small", TRAINER_GPT, (4, 16)), kill_steps=5, kill_after=3,
        adamw=dict(lr=1e-2, weight_decay=0.1), init={"num_cpus": 6, "num_gpus": 1}, device="cpu")
    launches = {}
    chip_smoke.phase_mpmd(launches, None, spec)
    assert set(launches["mpmd"]) == set(chip_smoke._kernels()) and not any(launches["mpmd"].values())

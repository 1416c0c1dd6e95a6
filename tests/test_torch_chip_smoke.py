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
        pipe=("llama-7b", {**TRAINER_LLAMA, "n_layers": 4}, (4, 16)), micro=2, warm=1, timed=3, fresh=2,
        parity=("llama-7b", TRAINER_LLAMA, (2, 16)),
        kill=("gpt2-small", TRAINER_GPT, (4, 16)), kill_steps=5, kill_after=3,
        adamw=dict(lr=1e-2, weight_decay=0.1), init={"num_cpus": 6, "num_gpus": 1}, device="cpu")
    launches = {}
    chip_smoke.phase_mpmd(launches, None, spec)
    assert set(launches["mpmd"]) == set(chip_smoke._kernels()) and not any(launches["mpmd"].values())


def test_data_phase_is_after_mpmd():
    assert chip_smoke.PHASES.index("data") == chip_smoke.PHASES.index("mpmd") + 1


def test_data_rows_are_reproducible_from_their_seeds():
    """The feed's map_batches fn draws row r from default_rng(seed + r)
    alone: the same row whatever block or batch it arrives in, so the
    driver recomputes the rows the trainer took."""
    fn = chip_smoke._data_fn(chip_smoke.DATA_SEED, 50304, 1025)
    out = fn({"id": np.array([3, 1, 7], np.int64)})
    assert out["tokens"].shape == (3, 1025) and out["tokens"].dtype == np.int64
    assert out["id"].tolist() == [3, 1, 7]
    for r, row in zip((3, 1, 7), out["tokens"]):
        assert np.array_equal(row, np.random.default_rng(1000 + r).integers(0, 50304, 1025))
    assert np.array_equal(fn({"id": np.array([7])})["tokens"][0], out["tokens"][2])
    assert fn({"id": np.zeros(0, np.int64)})["tokens"].shape == (0, 1025)


def test_step_launch_prediction():
    """One plain step's launches: gpt2-large with remat "attn" (the feed
    cell) 36 / 36 / 36 / 0, as the trainer phase; with full remat (the HF
    cell at 24 layers, config_from_hf's default) the backward reruns each
    flash forward, 48 / 24 / 24 / 0; llama (RMSNorm) recomputes its norms. The plain step
    is the MPMD prediction at one stage, one chunk, one microbatch."""
    from ray_tpu_torch.models.gpt import gpt2_large, llama_7b
    from ray_tpu_torch.train.huggingface import config_from_hf

    def plain(cfg):
        return chip_smoke.mpmd_launches(cfg, 1, 1, 1, 1)

    assert plain(chip_smoke._trainer_cfg(chip_smoke.DataSpec().feed)) == {
        "flash_fwd": 36, "flash_bwd_dq": 36, "flash_bwd_dkv": 36, "rmsnorm": 0}
    hf_cfg = config_from_hf(chip_smoke.types.SimpleNamespace(**chip_smoke.DataSpec().hf))
    assert hf_cfg.vocab_size == 50304 and hf_cfg.remat and hf_cfg.remat_policy is None
    assert plain(hf_cfg) == {"flash_fwd": 48, "flash_bwd_dq": 24, "flash_bwd_dkv": 24, "rmsnorm": 0}
    assert plain(gpt2_large(remat=False)) == {"flash_fwd": 36, "flash_bwd_dq": 36, "flash_bwd_dkv": 36,
                                              "rmsnorm": 0}
    assert plain(llama_7b(n_layers=4, remat=True, remat_policy="attn")) == {
        "flash_fwd": 4, "flash_bwd_dq": 4, "flash_bwd_dkv": 4, "rmsnorm": 17}


def test_hf_state_dict_has_gpt2s_names_and_round_trips():
    from ray_tpu_torch.train.huggingface import config_from_hf, params_from_hf, params_to_hf_state_dict

    hf = dict(n_embd=32, n_layer=2, n_head=2, n_inner=64, vocab_size=100, n_positions=16)
    sd = chip_smoke._hf_state_dict(hf, 5, "cpu")
    assert sd["transformer.h.1.attn.c_attn.weight"].shape == (32, 96)  # Conv1D [in, out]
    assert sd["transformer.h.0.mlp.c_proj.weight"].shape == (64, 32)
    assert sd["lm_head.weight"] is sd["transformer.wte.weight"] and len(sd) == 4 + 12 * 2 + 1
    assert all(torch.equal(a, b) for a, b in zip(sd.values(), chip_smoke._hf_state_dict(hf, 5, "cpu").values()))
    cfg = config_from_hf(chip_smoke.types.SimpleNamespace(**hf))
    back = params_to_hf_state_dict(params_from_hf(sd, cfg)[0], cfg, hf_vocab_size=100)
    assert set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())


HF_TINY = dict(n_embd=32, n_layer=2, n_head=2, n_inner=64, vocab_size=100, n_positions=16)


def test_data_phase_rehearsal_on_the_cpu():
    """The data phase's control flow, rehearsed on the CPU with tiny models
    in a cluster with one advertised GPU and no card (every kernel's plain
    version, so no launch is counted; one torch thread, so the driver's and
    the worker's products agree bit for bit): the feed's rows made by CPU
    tasks and taken in order through the streaming ingest, its losses and
    grad norms equal the in-process ones; the HF state dict's round trip,
    TransformersTrainer's losses equal to the driver's run of its step, its
    checkpoint exported; the session's processes gone."""
    spec = chip_smoke.DataSpec(feed=("gpt2-small", TRAINER_GPT, (2, 16)), warm=1, timed=2, parallelism=4,
                               hf=HF_TINY, hf_rows=8, hf_batch=2, hf_steps=3,
                               init={"num_cpus": 4, "num_gpus": 1}, device="cpu", threads=1)
    threads = torch.get_num_threads()
    launches = {}
    try:
        chip_smoke.phase_data(launches, None, spec)
    finally:
        torch.set_num_threads(threads)
    for path in ("data", "hf"):
        assert set(launches[path]) == set(chip_smoke._kernels()) and not any(launches[path].values())


def test_gbdt_and_rllib_phases_are_after_data():
    assert chip_smoke.PHASES.index("gbdt") == chip_smoke.PHASES.index("data") + 1
    assert chip_smoke.PHASES.index("rllib") == chip_smoke.PHASES.index("gbdt") + 1


def test_rllib_algos_phase_is_right_after_rllib():
    assert chip_smoke.PHASES.index("rllib_algos") == chip_smoke.PHASES.index("rllib") + 1
    # Its bars are the reference tests' own (tests/test_rllib_algos.py, tests/test_rllib_offline.py).
    assert chip_smoke.RL_BARS == {"dqn": (130.0, 80), "impala": (130.0, 250), "appo": (130.0, 250),
                                  "a2c": (120.0, 150), "bc": (150.0, 10), "marwil": (150.0, 15)}
    assert chip_smoke.RLlibAlgosSpec().bars == chip_smoke.RL_BARS


def test_higgs_like_rows_are_seeded_and_learnable():
    X, y = chip_smoke.higgs_like(5000, chip_smoke.GBDT_SEED)
    assert X.shape == (5000, 28) and X.dtype == np.float32 and y.dtype == np.float32
    assert 0.3 < y.mean() < 0.7 and (X[:, 14:] > 0).all()
    X2, y2 = chip_smoke.higgs_like(5000, chip_smoke.GBDT_SEED)
    assert np.array_equal(X, X2) and np.array_equal(y, y2)


def test_split_differences_count_reachable_nodes_only():
    """A differing split counts where a sample can reach it; below a leaf
    the arrays hold whatever the argmax left, which no prediction reads."""
    is_leaf = np.array([[False, True, False, True, True, True, True]])
    a = {"feat": np.array([[1, 0, 2, 0, 0, 0, 0]]), "thresh": np.array([[5, 0, 7, 0, 0, 0, 0]]), "is_leaf": is_leaf}
    assert chip_smoke._reachable(is_leaf).tolist() == [[True, True, True, False, False, True, True]]
    b = {k: v.copy() for k, v in a.items()}
    b["feat"][0, 3] = 4  # below the leaf at node 1: unreachable
    assert chip_smoke._split_differences(a, b) == []
    b["thresh"][0, 2] = 8
    assert chip_smoke._split_differences(a, b) == [(0, 2)]


def test_near_tie_finds_complementary_splits():
    """Two splits that cut a node into the same halves (one the mirror of
    the other) have equal f64 gains: a gap of 0, a near-tie; a split on a
    noise feature is not."""
    from ray_tpu_torch.models import gbdt

    rng = np.random.default_rng(0)
    X = rng.standard_normal((400, 3)).astype(np.float32)
    X[:, 1] = -X[:, 0]
    y = (X[:, 0] > 0).astype(np.float32)
    p = gbdt.GBDTParams(objective="binary_logistic", num_boost_round=1, max_depth=1, max_bins=16)
    model = gbdt.GradientBoostedTrees(p, device="cpu").fit(X, y)
    bins = gbdt.apply_bins(X, model.edges)
    f, b = int(model.trees["feat"][0, 0]), int(model.trees["thresh"][0, 0])
    assert f in (0, 1)
    left = bins[:, f] <= b
    # The mirror split: the other feature's threshold that puts the same rows left... on its right.
    g = 1 - f
    mirror = next(t for t in range(16) if np.array_equal(bins[:, g] <= t, ~left))
    other = {k: v.copy() for k, v in model.trees.items()}
    other["feat"][0, 0], other["thresh"][0, 0] = g, mirror
    gap, scale = chip_smoke._near_tie(X, y, other, model.trees, model, 0, 0, p)
    assert gap <= chip_smoke.GBDT_TIE_TOL * scale
    other["feat"][0, 0], other["thresh"][0, 0] = 2, 7
    gap, scale = chip_smoke._near_tie(X, y, other, model.trees, model, 0, 0, p)
    assert gap > chip_smoke.GBDT_TIE_TOL * scale


def test_gbdt_phase_rehearsal_on_the_cpu():
    """The gbdt phase's control flow on the CPU at a tiny size: two fits
    equal, the loss falling and beating the base rate, the index_put_
    histogram deterministic, "card" vs CPU (both the CPU here), and
    XGBoostTrainer in a cluster on a CPU worker (the rehearsal has no card)
    with its rows in order and its trees the in-process fit's; 0 launches
    of each kernel."""
    spec = chip_smoke.GBDTSpec(rows=6000, valid_rows=2000, rounds=5, parity_rows=3000, parity_rounds=3,
                               block_rows=1000, init={"num_cpus": 4, "num_gpus": 1}, device="cpu")
    launches = {}
    chip_smoke.phase_gbdt(launches, spec)
    assert set(launches["gbdt"]) == set(chip_smoke._kernels()) and not any(launches["gbdt"].values())


def test_rllib_phase_rehearsal_on_the_cpu():
    """The rllib phase's control flow on the CPU at a small size: PPO
    CartPole to a low gate, the update "card" vs CPU (both the CPU here),
    Pendulum, two-policy MultiAgentPPO, the cnn encoder, and the remote
    runners and a remote learner (a CPU worker here) in a cluster with save
    -> restore; 0 launches of each kernel."""
    spec = chip_smoke.RLlibSpec(envs=8, batch=512, minibatch=128, epochs=4, gate=30.0, max_steps=20_000,
                                remote_runners=2, remote_envs=4, remote_iters=2, pendulum_iters=1, ma_iters=2,
                                cnn_shape=(16, 16, 4), cnn_batch=8, init={"num_cpus": 4, "num_gpus": 1},
                                device="cpu")
    launches = {}
    chip_smoke.phase_rllib(launches, spec)
    assert set(launches["rllib"]) == set(chip_smoke._kernels()) and not any(launches["rllib"].values())


def test_rllib_algos_phase_rehearsal_on_the_cpu():
    """The rllib_algos phase's control flow on the CPU at low bars (the
    learning bars run on the card): each algorithm at its reference test's
    settings to its bar, its update "card" vs CPU (both the CPU here), CQL
    on transition data, IMPALA's async path and Ape-X's shards in a
    cluster; 0 launches of each kernel."""
    bars = {"dqn": (25.0, 25), "impala": (30.0, 40), "appo": (30.0, 40), "a2c": (25.0, 20), "bc": (60.0, 3),
            "marwil": (60.0, 3)}
    spec = chip_smoke.RLlibAlgosSpec(bars=bars, async_envs=4, async_iters=3, apex_iters=3, cql_iters=2,
                                     init={"num_cpus": 4}, device="cpu")
    launches = {}
    chip_smoke.phase_rllib_algos(launches, spec)
    assert set(launches["rllib_algos"]) == set(chip_smoke._kernels()) and not any(launches["rllib_algos"].values())


def test_rllib_algos_ii_phase_is_right_after_rllib_algos():
    assert chip_smoke.PHASES.index("rllib_algos_ii") == chip_smoke.PHASES.index("rllib_algos") + 1
    # Its bars and settings are the reference tests' own (tests/test_rllib_algos.py:76-89,174-190,210-226,
    # tests/test_rllib_dt.py:44-67).
    assert chip_smoke.RL_BARS_II == {"sac": (-350.0, 200), "td3": (-350.0, 200), "ddpg": (-400.0, 200),
                                     "dt": (150.0, 8)}
    assert chip_smoke.PENDULUM_TRAINING == dict(train_batch_size=256, learning_starts=512, num_grad_steps=256,
                                                minibatch_size=128, model={"hidden": (64, 64)})
    assert chip_smoke.PENDULUM_LR == {"sac": 3e-4, "td3": 1e-3, "ddpg": 1e-3}
    spec = chip_smoke.RLlibAlgosIISpec()
    assert spec.bars == chip_smoke.RL_BARS_II and spec.dt_episodes == 40 and spec.training == {}


def test_rllib_algos_ii_phase_rehearsal_on_the_cpu():
    """The rllib_algos_ii phase's control flow on the CPU at low bars and
    short updates (the learning bars run on the card): SAC, TD3 and DDPG
    until Pendulum's first episodes end, DT from 8 expert episodes, each
    update "card" vs CPU (both the CPU here; the graph-against-eager check
    runs on the card only); 0 launches of each kernel."""
    bars = {"sac": (-2000.0, 8), "td3": (-2000.0, 8), "ddpg": (-2000.0, 8), "dt": (20.0, 2)}
    spec = chip_smoke.RLlibAlgosIISpec(bars=bars, dt_episodes=8, training={"num_grad_steps": 4, "learning_starts": 256},
                                       device="cpu")
    launches = {}
    chip_smoke.phase_rllib_algos_ii(launches, spec)
    assert set(launches["rllib_algos_ii"]) == set(chip_smoke._kernels())
    assert not any(launches["rllib_algos_ii"].values())


def test_rllib_dreamer_phase_is_right_after_rllib_algos_ii():
    assert chip_smoke.PHASES.index("rllib_dreamer") == chip_smoke.PHASES.index("rllib_algos_ii") + 1
    # Its smoke and bar are the reference tests' own (tests/test_rllib_dreamer.py:28-67).
    assert chip_smoke.DREAMER_RUNNERS == dict(num_env_runners=0, num_envs_per_env_runner=8, rollout_fragment_length=64)
    assert chip_smoke.DREAMER_SMOKE == dict(num_grad_steps=4, batch_size_seqs=16)
    assert (chip_smoke.DREAMER_SMOKE_ITERS, chip_smoke.DREAMER_BAR) == (6, (130.0, 120))
    spec = chip_smoke.RLlibDreamerSpec()
    assert (spec.bar, spec.smoke_iters, spec.training, spec.device) == (chip_smoke.DREAMER_BAR, 6, {}, None)


def test_rllib_dreamer_phase_rehearsal_on_the_cpu():
    """The rllib_dreamer phase's control flow on the CPU at a low bar and
    short updates (the learning bar runs on the card): the world-model
    smoke at its settings, the bar run updating from its first iteration,
    the update "card" vs CPU (both the CPU here; the graph-against-eager
    check runs on the card only); 0 launches of each kernel."""
    spec = chip_smoke.RLlibDreamerSpec(bar=(10.0, 3), device="cpu",
                                       training={"num_grad_steps": 2, "batch_size_seqs": 4, "learning_starts": 512})
    launches = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # thousands of small ops: a loaded machine's thread pool slows them
    try:
        chip_smoke.phase_rllib_dreamer(launches, spec)
    finally:
        torch.set_num_threads(threads)
    assert set(launches["rllib_dreamer"]) == set(chip_smoke._kernels())
    assert not any(launches["rllib_dreamer"].values())


def test_rllib_podracer_phase_is_right_after_rllib_dreamer():
    assert chip_smoke.PHASES.index("rllib_podracer") == chip_smoke.PHASES.index("rllib_dreamer") + 1
    # Its settings are the reference tests' own (tests/test_podracer_anakin.py:95-108,
    # tests/test_podracer_sebulba.py:21-57).
    spec = chip_smoke.RLlibPodracerSpec()
    assert (spec.envs, spec.rollout, spec.minibatch, spec.epochs, spec.lr, spec.iters, spec.factor, spec.floor) == \
        (64, 32, 512, 4, 2.5e-3, 15, 2.0, 50.0)
    assert (spec.actors, spec.actor_envs, spec.actor_rollout, spec.sebulba_minibatch, spec.sebulba_epochs,
            spec.sebulba_lr, spec.sebulba_iters, spec.wide_envs, spec.device) == (2, 32, 128, 2048, 2, 1e-3, 2, 4096,
                                                                                  None)


def test_rllib_podracer_phase_rehearsal_on_the_cpu():
    """The rllib_podracer phase's control flow on the CPU at a small size
    and a low floor (the learning bar runs on the card): Anakin's rollout
    against itself eager, its bar, card vs CPU (both the CPU here), the
    wide iteration; Sebulba booting its own cluster, its transport stats,
    the SIGKILL, the update card vs CPU; 0 launches of each kernel."""
    spec = chip_smoke.RLlibPodracerSpec(envs=16, rollout=16, minibatch=128, epochs=2, iters=4, factor=1.0,
                                        floor=5.0, wide_envs=64, device="cpu")
    launches = {}
    chip_smoke.phase_rllib_podracer(launches, spec)
    assert set(launches["rllib_podracer"]) == set(chip_smoke._kernels())
    assert not any(launches["rllib_podracer"].values())


def test_mpmd_draws_each_cpu_param_set_once(monkeypatch):
    """Within `_cpu_params_drawn_once` a CPU draw of one (config, seed) is
    made once and every call gets its tensors, bit for bit a fresh draw; a
    draw from another seed or from a generator is not cached; the library's
    `init_params` is back after the block."""
    from ray_tpu_torch.models import gpt

    cfg = chip_smoke._trainer_cfg(("llama-7b", {**TRAINER_LLAMA, "n_layers": 2}, (2, 16)))
    fresh = gpt.init_params(cfg, seed=3, device="cpu")
    draw, calls = gpt.init_params, []
    monkeypatch.setattr(gpt, "init_params", lambda *a, **k: calls.append(a) or draw(*a, **k))
    patched = gpt.init_params
    with chip_smoke._cpu_params_drawn_once():
        a = gpt.init_params(cfg, seed=3, device="cpu")
        b = gpt.init_params(cfg, seed=3, device="cpu")
        gpt.init_params(cfg, seed=4, device="cpu")
        gpt.init_params(cfg, seed=torch.Generator().manual_seed(3), device="cpu")
    assert gpt.init_params is patched and len(calls) == 3
    assert all(a[k] is b[k] and torch.equal(b[k], fresh[k]) for k in fresh)

"""`chip_smoke.py`'s build guard, checked on the CPU against ptxas and
cuobjdump output of the bf16 flash kernels (forward, backward dQ and
dK/dV): a build whose wgmma products ptxas serialised, that spills, or that
lacks an instantiation, fails; a pipelined one passes."""

import pytest

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

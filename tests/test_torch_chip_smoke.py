"""`chip_smoke.py`'s build guard, checked on the CPU against ptxas and
cuobjdump output of the bf16 flash forward: a build whose wgmma products
ptxas serialised, or that spills, fails; a pipelined one passes."""

import pytest

import chip_smoke

FN = "_ZN45_GLOBAL__N__a66d6197_12_flash_fwd_cu_e1dd8ece14flash_fwd_bf16ILi128EEEv14CUtensorMap_stS1_S1_PtPfiiiifiii"
NOTE = ("ptxas info    : (C7513) Potential Performance Loss: wgmma.mma_async instructions are serialized "
        "due to non wgmma instructions defining input registers of a wgmma between start and end of the "
        "pipeline stage")


def _report(spill_bytes=0, note=None):
    lines = [f"ptxas info    : Compiling entry function '{FN}' for 'sm_90a'",
             f"ptxas info    : Function properties for {FN}",
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


HGMMA = "        /*1680*/                   HGMMA.64x128x16.F32.BF16 R88, gdesc[UR8], R88, gsb0 ;"
DEPBAR = "        /*17a0*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;"
ARRIVE = "        /*15c0*/                   WARPGROUP.ARRIVE ;"
TMA = "        /*a260*/                   UTMALDG.4D [UR8], [UR24] ;"
STORE = "        /*b000*/                   UTMASTG.4D [UR4], [UR6] ;"


def _sass(body, fn=FN):
    return "\n".join([f"\t\tFunction : {fn}", *body])


def test_pipelined_sass_passes():
    body = [TMA] * 6 + [ARRIVE] + [HGMMA] * 8 + [DEPBAR] + [ARRIVE] + [HGMMA] * 16 + [DEPBAR] * 2 + [STORE] * 2
    counts = chip_smoke.sass_counts(_sass(body) + "\n\t\tFunction : _Z10rmsnorm_fwdv\n" + HGMMA)
    assert counts == {"D=128": {"HGMMA": 24, "UTMALDG": 6, "UTMASTG": 2, "DEPBAR": 3}}
    chip_smoke.check_sass(counts)


@pytest.mark.parametrize("case", ["serialised", "no HGMMA", "no UTMALDG", "no flash forward"])
def test_bad_sass_fails(case):
    body = {
        # ptxas's serialisation: a wait after every product
        "serialised": [TMA] * 6 + [ARRIVE, HGMMA, DEPBAR] * 32,
        "no HGMMA": [TMA] * 6 + [DEPBAR],
        "no UTMALDG": [ARRIVE] + [HGMMA] * 8 + [DEPBAR],
        "no flash forward": [],
    }[case]
    fn = "_Z10rmsnorm_fwdv" if case == "no flash forward" else FN
    counts = chip_smoke.sass_counts(_sass(body, fn))
    with pytest.raises(AssertionError):
        chip_smoke.check_sass(counts)

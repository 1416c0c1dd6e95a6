"""`chip_smoke.py`'s profile reader: `device_events` reads the profiler's
raw results and gives the events, names and times (µs from the trace's
start) that `prof.events()` gives for a device, user annotations left out,
without building the event tree. Checked here on CPU events, which take the
same path as the card's."""

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke


def test_device_events_equal_the_profilers_own():
    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("an annotation"):
            y = x
            for _ in range(200):
                y = torch.tanh(y @ x)
    cpu = torch.autograd.DeviceType.CPU
    want = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == cpu and not e.is_user_annotation]
    got = chip_smoke.device_events(prof, cpu)
    assert len(got) >= 600 and sorted(got) == sorted(want)
    assert "an annotation" not in {name for name, _, _ in got}
    assert chip_smoke.device_events(prof, torch.autograd.DeviceType.CUDA) == []

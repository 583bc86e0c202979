"""The readers of the program's own spans (`harness.program_trace`) over
made-up records and profiler events, so every number is exact."""

from __future__ import annotations

import numpy as np
import pytest

from harness import program_trace as pt
from harness.trace import WINDOW, Event
from harness.window import Request
from repro_torch.trace import FIELDS, Records

MS = 1_000_000          # ns


def records(*spans):
    """Records from (name, start ms, end ms, parent, a0, a1[, tid])."""
    names, table = [], []
    for s in spans:
        name, start, end, parent, a0, a1 = s[:6]
        tid = s[6] if len(s) > 6 else 7
        if name not in names:
            names.append(name)
        table.append([names.index(name), int(start * MS), int(end * MS),
                      parent, -1, tid, a0, a1])
    return Records(tuple(names), np.array(table, np.int64).reshape(
        -1, len(FIELDS)))


def two_batches():
    """A 100 ms window (t 1.000-1.100 s) with two micro-batches dispatched
    inside it and one before it."""
    return records(
        ("vita.server.dispatch", 990, 999, -1, 32, 32),          # 0
        ("vita.server.stage", 990, 993, 0, 0, 0),                # 1
        ("vita.server.dispatch", 1010, 1030, -1, 32, 32),        # 2
        ("vita.server.stage", 1010, 1014, 2, 0, 0),              # 3
        ("vita.server.copy", 1014, 1015, 2, 0, 0),               # 4
        ("vita.server.forward", 1015, 1029, 2, 72, 1_440_000),   # 5
        ("vita.server.wait", 1030, 1040, -1, 0, 0),              # 6
        ("vita.server.dispatch", 1050, 1070, -1, 32, 32),        # 7
        ("vita.server.stage", 1050, 1056, 7, 0, 0),              # 8
        ("vita.server.copy", 1056, 1058, 7, 0, 0),               # 9
        ("vita.server.forward", 1058, 1068, 7, 72, 2_160_000),   # 10
        ("vita.server.wait", 1095, 1105, -1, 0, 0),              # 11
        ("vita.host.gc", 1080, 1083, -1, 2, 0),                  # 12
        ("vita.host.gc", 1099, 1102, -1, 0, 0),                  # 13
        ("vita.server.forward", 1106, 0, 7, 0, 0),               # open
    )


def test_per_micro_batch_means_count_the_window_only():
    r = two_batches()
    assert pt.stage_host_ms(r, 1.0, 1.1) == pytest.approx(5.0)
    assert pt.forward_host_ms(r, 1.0, 1.1) == pytest.approx(12.0)
    assert pt.mean_ms(r, "vita.server.dispatch", 1.0, 1.1) == \
        pytest.approx(20.0)
    assert pt.stage_host_ms(r, 2.0, 3.0) is None
    parts = pt.dispatch_parts_ms(r, 1.0, 1.1)
    assert parts == pytest.approx({"dispatch": 20.0, "stage": 5.0,
                                   "copy": 1.5, "forward": 12.0,
                                   "inside": 18.5})


def test_launch_host_time_is_launch_ns_over_launches():
    r = two_batches()
    # (1.44 + 2.16) ms over 144 launches
    assert pt.launch_host_us(r, 1.0, 1.1) == pytest.approx(25.0)
    none = records(("vita.server.forward", 1010, 1020, -1, 0, 0))
    assert pt.launch_host_us(none, 1.0, 1.1) is None


def test_waits_and_collector_pauses_are_clipped_to_the_window():
    r = two_batches()
    # 10 ms + the 5 ms of the second wait inside the window
    assert pt.host_wait_pct(r, 1.0, 1.1) == pytest.approx(15.0)
    assert pt.gc_pause_ms(r, 1.0, 1.1) == pytest.approx(4.0)
    assert pt.gc_pause_ms(r, 1.2, 1.3) == 0.0
    assert pt.host_wait_pct(records(("vita.host.gc", 1, 2, -1, 0, 0)),
                            0.0, 1.0) is None


def test_queue_delay_inside_the_hosts_wait():
    r = two_batches()            # waits 1030-1040 and 1095-1105 ms
    reqs = [Request(0, 0, t_due=1.025, t_start=1.050, t_done=1.1),   # 10/25
            Request(1, 0, t_due=1.041, t_start=1.050, t_done=1.1),   # 0/9
            Request(2, 0, t_due=1.020, t_start=1.100, t_done=1.2)]   # 15/80
    assert pt.queue_in_wait_pct(r, reqs) == pytest.approx(
        100 * 25 / 114)
    assert pt.queue_in_wait_pct(r, []) is None
    # over other spans: the collector's 1080-1083 and 1099-1100 ms
    assert pt.queue_in_wait_pct(r, reqs, "vita.host.gc") == pytest.approx(
        100 * 4 / 114)
    assert pt.queue_in_wait_pct(records(("vita.host.gc", 1, 2, -1, 0, 0)),
                                reqs) is None


def test_cover_is_the_union_of_the_serving_threads_spans():
    r = records(("vita.admission.step", 1000, 1040, -1, 0, 0),
                ("vita.server.dispatch", 1005, 1030, 0, 1, 1),
                ("vita.admission.submit", 1050, 1060, -1, 0, 0),
                ("vita.host.gc", 1060, 1100, -1, 0, 0, 99))   # other thread
    assert pt.covered_pct(r, 1.0, 1.1) == pytest.approx(50.0)
    assert pt.covered_pct(r, 1.0, 1.1, tid=99) == pytest.approx(40.0)
    assert pt.covered_pct(records(("vita.host.gc", 1, 2, -1, 0, 0)),
                          0.0, 1.0) is None


def test_spans_by_name_in_the_window():
    got = pt.by_name(two_batches(), 1.0, 1.1)
    assert got["vita.server.dispatch"] == (2, pytest.approx(40.0))
    assert got["vita.host.gc"] == (2, pytest.approx(6.0))
    assert list(got)[0] == "vita.server.dispatch"


def _events():
    """Window 0-100 us on thread 1; the device busy 10-20 and 60-90."""
    return [Event("host", WINDOW, 0, 100, 1),
            Event("device", "k", 10, 20), Event("device", "k", 60, 90),
            Event("host", "vita.admission.step", 5, 95, 1),
            Event("host", "vita.server.dispatch", 8, 40, 1),
            Event("host", "vita.server.forward", 25, 38, 1),
            Event("host", "vita.server.wait", 50, 95, 1),
            Event("host", "aten::empty", 30, 33, 1),          # not the program
            Event("host", "vita.host.gc", 0, 100, 2)]         # other thread


def test_idle_split_names_the_innermost_program_span():
    split = dict(pt.idle_split(_events()))
    # idle 0-10, 20-60, 90-100 (60 us in all)
    assert split == pytest.approx({
        pt.OUTSIDE: 10e-6,                        # 0-5, 95-100
        "vita.admission.step": 13e-6,             # 5-8, 40-50
        "vita.server.dispatch": 9e-6,             # 8-10, 20-25, 38-40
        "vita.server.forward": 13e-6,             # 25-38
        "vita.server.wait": 15e-6,                # 50-60, 90-95
    })
    assert sum(split.values()) == pytest.approx(60e-6)
    assert pt.idle_split(_events())[0][0] == "vita.server.wait"


def test_idle_split_without_program_ranges_is_all_outside():
    events = [e for e in _events() if not e.name.startswith("vita.")]
    assert pt.idle_split(events) == [(pt.OUTSIDE, pytest.approx(60e-6))]
    with pytest.raises(ValueError):
        pt.idle_split(events[1:])


def test_innermost_segments_cover_the_window_once():
    ranges = [e for e in _events() if e.tid == 1 and e.name != WINDOW
              and e.name.startswith("vita.")]
    segs = pt._innermost(ranges, 0, 100)
    assert segs[0] == (0, 5, None) and segs[-1] == (95, 100, None)
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    assert ("vita.server.forward" in {s[2] for s in segs})

"""Window arithmetic: a rate over the whole window, a tail over every
request, and a stall inside the window moving both.  A fake controller
serves on a fake clock, so the numbers are exact."""

from __future__ import annotations

import numpy as np
import pytest

from harness import traffic as tr
from harness import window as win


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


class Req:
    def __init__(self, rid, t_submit):
        self.rid, self.t_submit = rid, t_submit
        self.t_start = self.t_done = None


class FakeController:
    """Serves ``batch`` requests a step, each step taking ``step_s`` of the
    clock (``stall_s`` more for the step that starts after ``stall_at``)."""

    def __init__(self, clock, batch=4, step_s=0.01, stall_at=None,
                 stall_s=0.0):
        self.clock, self.batch, self.step_s = clock, batch, step_s
        self.stall_at, self.stall_s = stall_at, stall_s
        self.queue, self.ring = [], []
        self.n = 0

    @property
    def pending(self):
        return len(self.queue)

    @property
    def in_flight(self):
        return 0

    def submit(self, model, image, sla_ms=None, t_submit=None):
        r = Req(self.n, t_submit)
        self.n += 1
        self.queue.append(r)
        return r

    def step(self):
        group, self.queue = self.queue[:self.batch], self.queue[self.batch:]
        if not group:
            return 0
        t = self.clock()
        for r in group:
            r.t_start = t
        dt = self.step_s
        if self.stall_at is not None and t >= self.stall_at:
            dt += self.stall_s
            self.stall_at = None
        self.clock.sleep(dt)
        for r in group:
            r.t_done = self.clock()
        return len(group)

    def drain(self):
        while self.queue:
            self.step()


def _closed(stall_s):
    clock = Clock()
    ctl = FakeController(clock, batch=4, step_s=0.01, stall_at=100.5,
                         stall_s=stall_s)
    feed = tr.Feed(ctl, "m", list(range(8)), tr.image_order(0, 8), None)
    t_open, t_close = tr.drive_closed(feed, 4, 0.1, 1.0, clock=clock)
    return feed.requests(), t_open, t_close


def test_closed_rate_counts_every_completion_over_the_whole_window():
    reqs, t_open, t_close = _closed(0.0)
    assert t_close - t_open == pytest.approx(1.0)
    # 4 images every 10 ms
    assert win.rate(reqs, t_open, t_close) == pytest.approx(400, rel=0.02)


def test_a_stall_in_the_window_lowers_the_rate_and_raises_the_tail():
    reqs, t_open, t_close = _closed(0.0)
    slow, s_open, s_close = _closed(0.3)
    assert win.rate(slow, s_open, s_close) == pytest.approx(
        0.7 * win.rate(reqs, t_open, t_close), rel=0.03)
    fast_p = win.percentile_ms([r.latency_s for r in
                                win.completed_in(reqs, t_open, t_close)], 100)
    slow_p = win.percentile_ms([r.latency_s for r in
                                win.completed_in(slow, s_open, s_close)], 100)
    assert fast_p == pytest.approx(10.0)
    assert slow_p == pytest.approx(310.0)


def test_open_latency_counts_from_the_due_time_and_keeps_drained_requests():
    """Arrivals at 800/s against a server of 400/s: the backlog grows, and
    the requests still queued when arrivals stop are drained and count."""
    clock = Clock()
    ctl = FakeController(clock, batch=4, step_s=0.01)
    feed = tr.Feed(ctl, "m", list(range(8)), tr.image_order(0, 8), None)
    due = np.arange(0.0, 0.5, 1 / 800)
    t0, late = tr.drive_open(feed, due, clock=clock, sleep=clock.sleep)
    reqs = feed.requests()
    assert len(reqs) == len(due)
    assert len(win.due_in(reqs, t0, t0 + 0.5)) == len(due)
    assert max(r.t_done for r in reqs) > t0 + 0.9     # drained after 0.5 s
    lat = [r.latency_s for r in reqs]
    # the last request waited behind half the stream
    assert max(lat) == pytest.approx(0.5, abs=0.02)
    assert win.percentile_ms(lat, 95) > win.percentile_ms(lat, 50) > 100
    # the generator submits late while a step blocks, never early
    assert min(late) >= 0 and max(late) <= 0.0101
    # each request's latency runs from its due time, not its submit
    assert all(r.t_due == pytest.approx(t0 + d) for r, d in zip(reqs, due))


def test_percentile_interpolates_over_every_value():
    assert win.percentile_ms([0.001 * i for i in range(1, 101)], 95) == \
        pytest.approx(95.05)
    assert win.percentile_ms([], 50) is None


def test_arrivals_follow_the_seed_and_the_rate():
    t = tr.parse({"loop": "open", "rate_img_s": 2000, "sla_ms": 33,
                  "buckets": [1, 32], "bank": 64})
    a = tr.arrivals(t, 2 ** 31 + 5, 10.0)
    b = tr.arrivals(t, 2 ** 31 + 5, 10.0)
    c = tr.arrivals(t, 2 ** 31 + 6, 10.0)
    assert np.array_equal(a, b) and not np.array_equal(a[:50], c[:50])
    # every seed offers the same number of images, spread over the stream
    assert len(a) == len(c) == 20000
    assert np.all(np.diff(a) >= 0) and 0.0 <= a[0] and a[-1] < 10.0
    per_second = np.bincount(a.astype(int), minlength=10)
    assert per_second.min() > 1800 and per_second.max() < 2200
    # Poisson in between: exponential gaps, coefficient of variation ~1
    gaps = np.diff(a)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.05)


def test_image_order_sends_every_image_equally_often():
    order = tr.image_order(3, 64, 640)
    assert np.array_equal(np.bincount(order, minlength=64), np.full(64, 10))


@pytest.mark.parametrize("params", [
    {"loop": "closed", "clients": 0, "buckets": [1], "bank": 4},
    {"loop": "open", "rate_img_s": 0, "buckets": [1], "bank": 4},
    {"loop": "sideways", "buckets": [1], "bank": 4},
    {"loop": "closed", "clients": 2, "buckets": [1], "bank": 4, "rate": 3},
])
def test_bad_traffic_files_are_refused(params):
    with pytest.raises(ValueError):
        tr.parse(params)

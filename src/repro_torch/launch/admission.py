"""Continuous-batching admission layer: open-stream vision serving (the
port's counterpart of `repro/launch/admission.py`, decision for decision).

`VisionServer.run()` drains a fixed request list with a barrier per
bucket: under an open request stream the device idles between drains and
a batch-1 straggler stalls a full bucket.  This module puts an admission
layer in front of the server's forward:

* **Continuous batching**: buckets refill as requests complete instead of
  a barrier per drain.  An in-flight dispatch ring (``max_inflight``,
  default 2) keeps the next micro-batch assembling while the current one
  executes: on the card `VisionServer.dispatch` stages the micro-batch in
  pinned memory, copies it asynchronously and launches the forward
  without waiting for the device, and `complete` reaps it.  Partial
  buckets are held back while the ring is non-empty: the device executes
  one stream, so delaying a straggler until the in-flight batch completes
  costs nothing and lets late arrivals fill the bucket.

* **SLA-aware bucket selection**: each request carries a latency budget
  (``sla_ms``); `select_bucket` picks the largest batch bucket whose
  MEASURED per-batch latency fits the tightest remaining budget of the
  head-of-queue group, degrading to the smallest bucket when none fits.
  Latencies come from a bench record (`latency_table_from_bench`) or a
  live measurement (`measure_bucket_latencies`).  A request whose
  deadline is already blown is scheduled for throughput (budget = inf).

* **Latency-path routing**: a tight-deadline single can route to a
  dedicated batch-1 server (``latency_servers``) when its measured
  batch-1 latency beats the throughput path's smallest bucket or the
  budget is infeasible on the throughput buckets.

* **Per-model multiplexing**: one `VisionServer` per model sharing the
  device; the scheduler picks the deepest queue at each assembly
  (round-robin on ties).

`poisson_trace` + `run_open_stream` / `run_drain_stream` are the
open-loop replays: the same Poisson arrival trace runs through
the admission layer and through the fixed-bucket drain baseline, so
sustained throughput and tail latency compare at equal offered load.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch import trace
from repro_torch.launch.vision_serve import (InFlight, VisionRequest,
                                             VisionServer)


# ---------------------------------------------------------------------------
# SLA bucket selection
# ---------------------------------------------------------------------------


def select_bucket(budget_ms: Optional[float],
                  latencies: Mapping[int, float]) -> int:
    """Pick a batch bucket for a latency budget from MEASURED per-batch
    latencies (``{bucket: ms}``).

    The contract (property-tested in tests/test_admission.py):

    * never picks a bucket whose measured latency exceeds the budget
      when any feasible bucket exists;
    * among feasible buckets picks the LARGEST (throughput-greedy
      subject to the SLA);
    * degrades to the smallest bucket when no bucket fits;
    * the choice is monotone (non-decreasing) in the budget.

    ``budget_ms`` of None/inf means no deadline: the largest bucket.
    Callers map already-blown deadlines to None BEFORE calling — a
    missed SLA is a throughput request, not a straggler (see
    `AdmissionController`).
    """
    if not latencies:
        raise ValueError("select_bucket needs at least one bucket")
    buckets = sorted(latencies)
    if budget_ms is None:
        return buckets[-1]
    feasible = [b for b in buckets if latencies[b] <= budget_ms]
    return max(feasible) if feasible else buckets[0]


def measure_bucket_latencies(server: VisionServer, *,
                             repeats: int = 2) -> Dict[int, float]:
    """Measure each bucket's end-to-end micro-batch latency (ms) on a
    live server: one warm-up dispatch per bucket (the kernels' first-call
    builds and plans), then the best of ``repeats`` timed
    dispatch+complete round trips.  Leaves the server's stats counters,
    ``done`` list and ``device_ms`` untouched (the probe requests are
    discarded), and with them the tracer's records and counters
    (`repro_torch.trace`), and warms every bucket as a side effect — which
    open-stream serving wants anyway.
    """
    cfg = server.cfg
    shape = (cfg.image, cfg.image, 3)
    done0, device0 = len(server.done), len(server.device_ms)
    batches0, padded0 = server.n_batches, server.n_padded
    traced = trace.mark()
    out: Dict[int, float] = {}
    for b in server.buckets:
        def probe():
            reqs = [VisionRequest(-1, np.zeros(shape, np.float32))
                    for _ in range(b)]
            t0 = time.perf_counter()
            server.complete(server.dispatch(reqs, b))
            return (time.perf_counter() - t0) * 1e3
        probe()                                  # warm-up
        out[b] = min(probe() for _ in range(max(repeats, 1)))
    del server.done[done0:]
    del server.device_ms[device0:]
    server.n_batches, server.n_padded = batches0, padded0
    trace.rewind(traced)
    return out


def latency_table_from_bench(record, model: str, mode: str, *,
                             mesh_shape: str = "1x1") -> Dict[int, float]:
    """``{bucket: per-batch service ms}`` for one (model, mode) from a
    bench record (a loaded ``BENCH_vision_serve.json`` dict or a path).
    Reads the fused throughput rows' ``wall_s / batches`` — the pure
    per-micro-batch service time (drain latency_p* include queue wait).
    Prefers rows of the requested ``mesh_shape``; keeps the fastest
    measurement per bucket."""
    if isinstance(record, (str, bytes)):
        with open(record) as f:
            record = json.load(f)
    table: Dict[int, float] = {}
    for r in record.get("runs", []):
        if (r.get("model") != model or r.get("mode") != mode
                or not r.get("fused") or r.get("latency_path")
                or r.get("load_path")
                or r.get("mesh_shape", "1x1") != mesh_shape
                or not r.get("batches")):
            continue
        ms = r["wall_s"] / r["batches"] * 1e3
        b = int(r["batch"])
        table[b] = min(table.get(b, float("inf")), ms)
    return table


# ---------------------------------------------------------------------------
# The admission controller
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Lane:
    """Per-model queue + serving paths."""
    name: str
    server: VisionServer
    latencies: Dict[int, float]
    latency_server: Optional[VisionServer] = None
    latency_b1_ms: Optional[float] = None
    queue: List[VisionRequest] = dataclasses.field(default_factory=list)
    last_tick: int = 0


class AdmissionController:
    """Open-stream admission in front of one or more `VisionServer`\\ s.

    ``servers`` maps model name -> throughput server (one per registered
    model, all sharing the device).  ``latencies`` maps model name ->
    measured ``{bucket: ms}`` table (from `latency_table_from_bench` or
    `measure_bucket_latencies`); models without one are measured live at
    construction — which also warms every bucket.  ``latency_servers``
    optionally maps model name -> a batch-1 latency-path server that
    tight-deadline singles route to.

    `submit` enqueues, `step` runs one scheduling iteration (refill the
    dispatch ring, then reap the oldest in-flight micro-batch), `drain`
    flushes.  All completed requests accumulate in ``completed`` with
    queue-delay and service-time stamped separately.
    """

    def __init__(self, servers: Dict[str, VisionServer], *,
                 latencies: Optional[Dict[str, Mapping[int, float]]] = None,
                 latency_servers: Optional[Dict[str, VisionServer]] = None,
                 max_inflight: int = 2, measure_repeats: int = 2):
        assert servers, "AdmissionController needs at least one server"
        assert max_inflight >= 1
        self.max_inflight = int(max_inflight)
        self.lanes: Dict[str, _Lane] = {}
        latencies = latencies or {}
        latency_servers = latency_servers or {}
        for name, server in servers.items():
            table = dict(latencies.get(name) or
                         measure_bucket_latencies(
                             server, repeats=measure_repeats))
            missing = [b for b in server.buckets if b not in table]
            if missing:
                table.update({b: ms for b, ms in measure_bucket_latencies(
                    server, repeats=measure_repeats).items()
                    if b in missing})
            lane = _Lane(name, server,
                         {b: float(table[b]) for b in server.buckets})
            lserver = latency_servers.get(name)
            if lserver is not None:
                lane.latency_server = lserver
                lane.latency_b1_ms = measure_bucket_latencies(
                    lserver, repeats=measure_repeats)[lserver.buckets[0]]
            self.lanes[name] = lane
        self.ring: List[Tuple[VisionServer, InFlight]] = []
        self.completed: List[VisionRequest] = []
        self.infeasible_served = 0
        self.routed_latency_path = 0
        self.held_partials = 0
        self._rid = 0
        self._tick = 0

    # -- request plane ----------------------------------------------------

    @property
    def pending(self) -> int:
        return sum(len(lane.queue) for lane in self.lanes.values())

    @property
    def in_flight(self) -> int:
        return sum(len(inf.requests) for _, inf in self.ring)

    def submit(self, model: str, image: np.ndarray,
               sla_ms: Optional[float] = None,
               t_submit: Optional[float] = None) -> VisionRequest:
        """Enqueue one request on its model's lane.  ``t_submit``
        overrides the arrival stamp (trace replay: the request's clock
        starts at its ARRIVAL time, even if the replay submits late)."""
        with trace.span("vita.admission.submit", -1, self._rid):
            lane = self.lanes[model]
            req = VisionRequest(self._rid, np.asarray(image), sla_ms=sla_ms)
            if t_submit is not None:
                req.t_submit = t_submit
            req.model = model
            req.path = "throughput"
            self._rid += 1
            lane.queue.append(req)
            return req

    # -- scheduling -------------------------------------------------------

    def _deadline(self, req: VisionRequest) -> Tuple[float, int]:
        if req.sla_ms is None:
            return (float("inf"), req.rid)       # FIFO behind deadlines
        return (req.t_submit + req.sla_ms / 1e3, req.rid)

    def _assemble(self, now: float):
        """Pick (server, request group, bucket, path) for one dispatch,
        or None when nothing should launch right now (empty queues, or a
        partial bucket held back while the ring is busy)."""
        with trace.span("vita.admission.assemble") as sp:
            held = self.held_partials
            plan = self._pick(now)
            sp.set(self.held_partials - held)
            return plan

    def _pick(self, now: float):
        """`_assemble`'s decision (the EDF sort, the group's fill, the
        hold-back)."""
        lanes = [ln for ln in self.lanes.values() if ln.queue]
        if not lanes:
            return None
        # weighted by queue depth: the deepest queue dispatches first;
        # ties rotate round-robin (least-recently-served lane)
        lane = min(lanes, key=lambda ln: (-len(ln.queue), ln.last_tick))
        lane.queue.sort(key=self._deadline)      # EDF order
        head = lane.queue[0]
        rem_head = head.remaining_budget_ms(now)
        # an already-blown deadline schedules for throughput — a
        # straggler bucket can't save its SLA and stalls everyone else
        budget = None if rem_head <= 0 or rem_head == float("inf") \
            else rem_head
        bucket = select_bucket(budget, lane.latencies)
        lat_b = lane.latencies[bucket]
        min_lat = min(lane.latencies.values())

        # latency-path routing: a deadline-pressed single whose budget
        # the latency server's measured batch-1 latency serves better
        # than the throughput path's pick
        if (lane.latency_server is not None and budget is not None
                and lane.latency_b1_ms is not None
                and bucket == lane.server.buckets[0]
                and (lane.latency_b1_ms <= lat_b or budget < lat_b)):
            lane.queue.pop(0)
            head.path = "latency"
            self.routed_latency_path += 1
            self._account_sla(head, now, lane.latency_b1_ms,
                              lane.latencies)
            self._tick += 1
            lane.last_tick = self._tick
            return (lane.latency_server, [head],
                    lane.latency_server.buckets[0], "latency")

        # fill the bucket in EDF order with requests the pick still
        # serves within budget (blown/infeasible requests may ride any
        # bucket — nothing can save them)
        group, rest = [], []
        for req in lane.queue:
            if len(group) == bucket:
                rest.append(req)
                continue
            rem = req.remaining_budget_ms(now)
            if rem <= 0 or rem >= lat_b or min_lat > rem:
                group.append(req)
            else:
                rest.append(req)
        # shrink a part-filled pick to the smallest bucket that holds it
        # (never to a SLOWER bucket — feasibility was proven for lat_b)
        fit = next(b for b in lane.server.buckets if b >= len(group))
        if fit < bucket and lane.latencies[fit] <= lat_b:
            bucket, lat_b = fit, lane.latencies[fit]
        if len(group) < bucket and self.ring:
            # partial bucket while the device is busy: hold — the
            # in-flight batch blocks it anyway, and late arrivals can
            # still fill the bucket before the ring empties
            self.held_partials += 1
            return None
        lane.queue[:] = rest
        for req in group:
            self._account_sla(req, now, lat_b, lane.latencies)
        self._tick += 1
        lane.last_tick = self._tick
        return (lane.server, group, bucket, "throughput")

    def _account_sla(self, req: VisionRequest, now: float,
                     chosen_ms: float,
                     latencies: Mapping[int, float]) -> None:
        """The SLA feasibility gate's bookkeeping: a request with any
        feasible bucket left must never ride an infeasible one."""
        rem = req.remaining_budget_ms(now)
        if rem == float("inf"):
            return
        feasible = any(ms <= rem for ms in latencies.values())
        if feasible and chosen_ms > rem:
            self.infeasible_served += 1

    def step(self, now: Optional[float] = None) -> int:
        """One scheduling iteration: refill the dispatch ring (assembly
        overlaps the executing batch: `dispatch` does not wait for the
        device), then block on the OLDEST in-flight micro-batch.  Returns
        the number of requests completed."""
        with trace.span("vita.admission.step"):
            now = time.perf_counter() if now is None else now
            while len(self.ring) < self.max_inflight:
                plan = self._assemble(now)
                if plan is None:
                    break
                server, group, bucket, _ = plan
                self.ring.append((server, server.dispatch(group, bucket)))
            if not self.ring:
                return 0
            server, inflight = self.ring.pop(0)
            served = server.complete(inflight)
            self.completed.extend(inflight.requests)
            return served

    def drain(self) -> int:
        """Flush every queued and in-flight request (stream shutdown)."""
        served = 0
        while self.pending or self.ring:
            served += self.step()
        return served

    # -- statistics -------------------------------------------------------

    def stats(self, wall_s: float,
              since: int = 0) -> Dict[str, object]:
        reqs = self.completed[since:]
        summary = stream_summary(reqs, wall_s)
        summary.update({
            "infeasible_served": self.infeasible_served,
            "routed_latency_path": self.routed_latency_path,
            "held_partials": self.held_partials,
            "per_model": {
                name: sum(1 for r in reqs
                          if getattr(r, "model", name) == name)
                for name in self.lanes},
        })
        return summary


def stream_summary(reqs: Sequence[VisionRequest],
                   wall_s: float) -> Dict[str, object]:
    """The shared open-stream stats row: sustained throughput over the
    whole stream plus tail latency with queue-delay / service-time split
    (no `restamp_queued` needed — the spans are stamped separately)."""
    n = len(reqs)
    if n == 0:
        zeros = {k: 0.0 for k in
                 ("throughput_img_s", "latency_p50_ms", "latency_p95_ms",
                  "latency_p99_ms", "latency_mean_ms",
                  "queue_delay_p50_ms", "queue_delay_p95_ms",
                  "service_p50_ms", "sla_miss_rate")}
        return {"requests": 0, "wall_s": wall_s, "sla_misses": 0, **zeros}
    lat = np.array([r.latency_s for r in reqs]) * 1e3
    queue = np.array([r.queue_delay_s for r in reqs]) * 1e3
    service = np.array([r.service_s for r in reqs]) * 1e3
    with_sla = [r for r in reqs if r.sla_ms is not None]
    misses = sum(1 for r in with_sla if r.latency_s * 1e3 > r.sla_ms)
    return {
        "requests": n,
        "wall_s": wall_s,
        "throughput_img_s": n / wall_s if wall_s > 0 else 0.0,
        "latency_p50_ms": float(np.percentile(lat, 50)),
        "latency_p95_ms": float(np.percentile(lat, 95)),
        "latency_p99_ms": float(np.percentile(lat, 99)),
        "latency_mean_ms": float(lat.mean()),
        "queue_delay_p50_ms": float(np.percentile(queue, 50)),
        "queue_delay_p95_ms": float(np.percentile(queue, 95)),
        "service_p50_ms": float(np.percentile(service, 50)),
        "sla_misses": int(misses),
        "sla_miss_rate": misses / len(with_sla) if with_sla else 0.0,
    }


# ---------------------------------------------------------------------------
# Open-loop load generation + stream replays
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop arrival: offset (s) from stream start, target model,
    latency budget, and an index into the replay's image bank."""
    t: float
    model: str
    sla_ms: Optional[float]
    image_idx: int


def poisson_trace(rate_hz: float, n: int, model, *,
                  sla_ms: Optional[float] = None, seed: int = 0,
                  n_images: int = 8) -> List[Arrival]:
    """``n`` Poisson arrivals at ``rate_hz`` (i.i.d. exponential gaps).
    ``model`` may be one name or a sequence to multiplex (uniform pick
    per arrival)."""
    assert rate_hz > 0 and n > 0
    rng = np.random.default_rng(seed)
    offsets = np.cumsum(rng.exponential(1.0 / rate_hz, size=n))
    models = [model] if isinstance(model, str) else list(model)
    picks = rng.integers(0, len(models), size=n)
    return [Arrival(float(t), models[int(m)], sla_ms, i % n_images)
            for i, (t, m) in enumerate(zip(offsets, picks))]


def load_trace(path: str, default_model: str,
               default_sla_ms: Optional[float] = None) -> List[Arrival]:
    """Load an arrival trace from JSON: ``{"arrivals": [{"t": seconds,
    "model": name?, "sla_ms": budget?}, ...]}`` (fields beyond ``t``
    optional; arrivals are sorted by ``t``)."""
    with open(path) as f:
        record = json.load(f)
    arrivals = sorted(record["arrivals"], key=lambda a: float(a["t"]))
    return [Arrival(float(a["t"]), a.get("model", default_model),
                    a.get("sla_ms", default_sla_ms), i % 8)
            for i, a in enumerate(arrivals)]


def run_open_stream(controller: AdmissionController,
                    trace: Sequence[Arrival],
                    images: Mapping[str, np.ndarray]) -> Dict[str, object]:
    """Replay ``trace`` through the admission layer in real time:
    arrivals are submitted at their offsets, the controller steps
    continuously (buckets refill as requests complete), the stream is
    drained at the end.  ``images`` maps model name -> image bank
    (indexed modulo by ``Arrival.image_idx``)."""
    since = len(controller.completed)
    t0 = time.perf_counter()
    i = 0
    while i < len(trace) or controller.pending or controller.ring:
        now = time.perf_counter() - t0
        while i < len(trace) and trace[i].t <= now:
            a = trace[i]
            bank = images[a.model]
            controller.submit(a.model, bank[a.image_idx % len(bank)],
                              sla_ms=a.sla_ms, t_submit=t0 + a.t)
            i += 1
        if controller.pending or controller.ring:
            controller.step()
        elif i < len(trace):
            time.sleep(min(max(trace[i].t - now, 0.0), 0.005))
    wall = time.perf_counter() - t0
    return controller.stats(wall, since=since)


def run_drain_stream(server: VisionServer, trace: Sequence[Arrival],
                     images: Mapping[str, np.ndarray]) -> Dict[str, object]:
    """The fixed-bucket drain BASELINE at the same offered load: arrivals
    queue up, and the server drains the list it sees to empty with a
    blocking barrier per bucket (`VisionServer.run` semantics — arrivals
    during a drain wait for the whole drain).  Same trace, same buckets,
    no SLA awareness, no dispatch overlap — the configuration the
    admission layer's Poisson rows are measured against."""
    done0 = len(server.done)
    t0 = time.perf_counter()
    i = 0
    while i < len(trace) or server.queue:
        now = time.perf_counter() - t0
        while i < len(trace) and trace[i].t <= now:
            a = trace[i]
            bank = images[a.model]
            req = server.submit(bank[a.image_idx % len(bank)])
            req.sla_ms = a.sla_ms
            req.t_submit = t0 + a.t
            i += 1
        if server.queue:
            server.run()                   # barrier: drain to empty
        elif i < len(trace):
            time.sleep(min(max(trace[i].t - now, 0.0), 0.005))
    wall = time.perf_counter() - t0
    return stream_summary(server.done[done0:], wall)

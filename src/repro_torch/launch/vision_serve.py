"""VisionServer — micro-batching driver (counterpart of
`repro/launch/vision_serve.py`).

Requests queue up; the server drains them in micro-batches, pads each
micro-batch up to the nearest batch bucket and runs the whole bucket
through one batched forward of the registered model (ViT/DeiT, Swin or
TNT): its compiled schedule, fused (one ``layer`` phase per encoder
block, and one ``inner_layer`` per TNT pixel block; the default) or
unfused (``msa`` + ``mlp`` phases, ``--no-fuse``).
``--fuse-group-size N`` (``ServeConfig.fuse_group``) also collapses runs
of up to N fused layers into ``layer_group`` phases, one kernel launch
each.  A `FusionPolicy` may decide fusion and group size per bucket
instead.

  * ``float`` — the fp32 path through the float layer kernel (fused) or
    the per-head MSA and fused MLP kernels (unfused);
  * ``int8``  — the PTQ deployment mode of Sec. III-A: per-channel int8
    weights and calibrated activation scales through the int8 layer
    kernel (fused) or the int8 MSA kernel (unfused) and the int8 matmul.

`dispatch` stamps each request's ``t_start`` just before it issues the
forward (as the JAX server stamps it at its asynchronous jitted call), so
``service_s`` spans the host's launches and the device's work.  On the
card it never waits for the device: it stacks and pads the micro-batch
into a fresh pinned host tensor, copies it with ``non_blocking=True``
(PyTorch's caching host allocator keeps the block until that copy's event
completes, so no later micro-batch overwrites it), launches the forward,
records a CUDA event before and after it, and queues the logits' copy
into a fresh pinned host tensor right behind it, with one more event
after that copy.  `complete` waits on the copy's event (which, in stream
order, also covers the forward), keeps the device time between the first
two events (``device_p50_ms`` of `run`) and copies the logits out of the
pinned block, which the allocator may then hand out again.  So the next
micro-batch can be assembled and launched while one runs, and the
read-back of one waits only for its own kernels, never for those of a
micro-batch dispatched after it: the in-flight ring of
`launch.admission`.  On the CPU the forward completes inside `dispatch`
and `complete` reads its logits as they are.  The server runs on the card
unless ``ServeConfig(device="cpu")`` asks otherwise.

Open-stream serving (`serve_stream`, ``--arrival-rate`` / ``--trace``)
replays an arrival trace through `launch.admission`'s continuous-batching
controller or its drain baseline; ``--profile`` (`profile_stats`) prints
the live HUE table (`core.hue`) after each mode's drain.

On a mesh (``ServeConfig.mesh``, ``data_parallel`` or ``mesh_shape``;
``--devices N`` / ``--mesh DxM`` / ``--latency-mesh DxM``) the server
runs in rank 0 of a `launch.mesh` world and keeps the request plane
there; every rank holds a `MeshReplica`, its shard of the served tree,
and each micro-batch is one mesh command: rank 0 sends the images, every
rank replays its rows on its shards (the batch on ``data``, the heads
and MLP columns on ``model``) and the logits are gathered on rank 0.
Buckets round up to the data-axis size, and a requested bucket 1
survives on a model-axis mesh (the batch-1 latency path).  Calibration
stays on rank 0's single device; only the frozen scales reach the
ranks.  A mesh dispatch waits for the device (the ranks meet in
collectives, which gloo stages through the host), so ``device_p50_ms``
is measured on single-device servers only.

Usage (on a machine with a card; ``--device cpu`` runs the plain path):
  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model deit_t \
      --full --mode both
  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model swin_t \
      --full --mode both --no-fuse
  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model tnt_s \
      --full --mode both
  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model deit_t \
      --full --mode both --fuse-group-size 4
  PYTHONPATH=src python -m repro_torch.launch.serve --vision \
      --model deit_t,swin_t --full --arrival-rate 500 --sla-ms 40 \
      --requests 128 --mode float
  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model deit_t \
      --full --mode both --profile
  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model deit_t \
      --full --mode both --mesh 1x3
  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model deit_t \
      --device cpu --mesh 1x2 --requests 6
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import hue as hue_lib
from repro_torch.core import schedule as sched_lib
from repro_torch.core.quant import Calibrator
from repro_torch.core.schedule import FusionPolicy
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import vision_registry, vit
from repro_torch.models.layers import to_device


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raises when the card is asked for and
    there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch path on the CPU")
    return dev


def round_buckets(buckets: Sequence[int],
                  data_parallel: int) -> Tuple[int, ...]:
    """Each batch bucket rounded up to a multiple of the DATA-axis size
    (deduplicated), so every padded micro-batch divides the mesh's batch
    axis.  ``data_parallel`` is the data axis alone, not the rank count:
    on a (2, 4) mesh only ``data`` carries rows, so buckets round to 2."""
    dp = max(int(data_parallel), 1)
    return tuple(sorted({-(-int(b) // dp) * dp for b in buckets}))


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """How a model is served: mode, batch buckets, the mesh (``mesh``, a
    `launch.mesh.VisionMesh`; or ``data_parallel`` ranks on a 1-D data
    mesh; or ``mesh_shape`` "DxM", which wins), an optional per-bucket
    `FusionPolicy`, the build fields `make_server` reads (``full``,
    ``fused``, ``fuse_group``, ``head_mask``, ``seed``, ``calib_images``)
    and the device (None = the card).  ``fused``, ``fuse_group`` and
    ``head_mask`` None keep the registry config's own fields (fused,
    ungrouped, the entry's mask)."""

    mode: str = "float"
    buckets: Tuple[int, ...] = (1, 2, 4, 8)
    mesh: Optional[Any] = dataclasses.field(default=None, compare=False)
    data_parallel: Optional[int] = None
    mesh_shape: Optional[Any] = None
    fusion_policy: Optional[FusionPolicy] = dataclasses.field(
        default=None, compare=False)
    full: bool = False
    fused: Optional[bool] = None
    fuse_group: Optional[int] = None
    head_mask: Optional[Any] = None
    seed: int = 0
    calib_images: int = 8
    device: Optional[str] = None

    def __post_init__(self):
        if self.mode not in ("float", "int8"):
            raise ValueError(
                f"mode must be 'float' or 'int8', got {self.mode!r}")
        buckets = tuple(int(b) for b in self.buckets)
        if not buckets or min(buckets) <= 0:
            raise ValueError(
                f"batch buckets must be positive, got {self.buckets!r}")
        object.__setattr__(self, "buckets", tuple(sorted(set(buckets))))
        if self.fuse_group is not None and int(self.fuse_group) < 1:
            raise ValueError(
                f"fuse_group must be >= 1, got {self.fuse_group!r}")


class VisionRequest:
    """One queued request, stamped at submit, dispatch and completion, so
    queue delay and service time are reported apart.  ``sla_ms`` is its
    latency budget (None: no deadline), which the admission layer's
    bucket selection (`launch.admission.select_bucket`) reads.  ``batch``
    is the id of its micro-batch's dispatch span while `repro_torch.trace`
    is on (else None)."""

    def __init__(self, rid: int, image: np.ndarray,
                 sla_ms: Optional[float] = None):
        self.rid = rid
        self.image = image
        self.sla_ms = sla_ms
        self.t_submit = time.perf_counter()
        self.t_start: Optional[float] = None
        self.t_done: Optional[float] = None
        self.pred: Optional[int] = None
        self.logits: Optional[np.ndarray] = None
        self.batch: Optional[int] = None

    @property
    def latency_s(self) -> float:
        if self.t_done is None:
            raise RuntimeError(f"request {self.rid} not served yet")
        return self.t_done - self.t_submit

    @property
    def queue_delay_s(self) -> float:
        if self.t_start is None:
            raise RuntimeError(f"request {self.rid} not dispatched yet")
        return self.t_start - self.t_submit

    @property
    def service_s(self) -> float:
        return self.latency_s - self.queue_delay_s

    def remaining_budget_ms(self, now: Optional[float] = None) -> float:
        """SLA budget left at ``now`` (inf when the request has none)."""
        if self.sla_ms is None:
            return float("inf")
        now = time.perf_counter() if now is None else now
        return self.sla_ms - (now - self.t_submit) * 1e3


class InFlight:
    """A dispatched micro-batch: its logits tensor (``out``), the host time
    it was dispatched at, its dispatch span's id (``batch``, -1 while
    `repro_torch.trace` is off) and, on a single card, the CUDA events
    recorded before (``start``) and after (``event``) its forward and
    behind its logits' copy (``copied``).  There ``out`` is the pinned host
    tensor that copy fills; elsewhere the three events are None and
    ``out`` is complete."""

    __slots__ = ("requests", "bucket", "out", "event", "start",
                 "t_dispatch", "batch", "copied")

    def __init__(self, requests: List[VisionRequest], bucket: int,
                 out: torch.Tensor, event, start=None,
                 t_dispatch: Optional[float] = None, batch: int = -1,
                 copied=None):
        self.requests = requests
        self.bucket = bucket
        self.out = out
        self.event = event
        self.start = start
        self.t_dispatch = t_dispatch
        self.batch = batch
        self.copied = copied


class MeshReplica:
    """One rank's part of a `VisionServer` on a mesh: its shard of the
    served tree on its device, the frozen scales, and one replay body
    (`core.schedule.build_sharded_fn`) per (fused, group size, batch
    divisibility), the reference's per-variant key on a model mesh (the
    divisibility fixes the batch spec: sharded over ``data``, or every
    data row computing the whole micro-batch)."""

    def __init__(self, tree, calibrator, mesh):
        self.mesh = mesh
        self.shapes = shd.meta_tree(tree)
        self.params = shd.shard_vision_params(tree, mesh)
        self.calibrator = calibrator
        self._fns: Dict[Tuple[bool, int, bool], Any] = {}

    def forward(self, cfg, images: torch.Tensor) -> torch.Tensor:
        """Whole (B, H, W, 3) images -> the whole batch's logits, on every
        rank of the mesh, through the schedule ``cfg`` serves."""
        b = images.shape[0]
        div = shd.vision_batch_spec(b, self.mesh)[0] is not None
        key = (bool(cfg.fused), int(cfg.fuse_group), div)
        fn = self._fns.get(key)
        if fn is None:
            fn = sched_lib.build_sharded_fn(
                vision_registry.make_schedule(cfg), self.shapes, self.mesh,
                batch=b, observer=self.calibrator,
                preprocess=functools.partial(vit.extract_patches,
                                             patch=cfg.patch))
            self._fns[key] = fn
        return fn(self.params, shd.shard_vision_batch(images, self.mesh))


class VisionServer:
    """Queue + pad-to-bucket micro-batching over a registered vision
    config (ViT/DeiT, Swin or TNT), on one device or on a mesh (module
    docstring)."""

    def __init__(self, cfg, params, *,
                 serve_cfg: Optional[ServeConfig] = None, qparams=None,
                 calibrator: Optional[Calibrator] = None,
                 model_name: Optional[str] = None):
        sc = serve_cfg if serve_cfg is not None else ServeConfig()
        self.serve_cfg = sc
        self.device = resolve_device(sc.device)
        self.mode = sc.mode
        if self.mode == "int8":
            if qparams is None:
                raise ValueError("int8 mode needs quantized params")
            if calibrator is None or calibrator.frozen is None:
                raise ValueError("int8 mode needs a frozen "
                                 "activation-scale calibrator")
            qparams = vit.to_device(qparams, self.device)
            calibrator = calibrator.to(self.device)
        else:
            params = vit.to_device(params, self.device)
        mesh = sc.mesh
        if mesh is None and sc.mesh_shape is not None:
            d, m = mesh_lib.parse_mesh_shape(sc.mesh_shape)
            if d * m > 1:
                mesh = mesh_lib.make_vision_mesh(d, m, self.device)
        if mesh is None and sc.data_parallel is not None \
                and sc.data_parallel > 1:
            mesh = mesh_lib.make_vision_mesh(sc.data_parallel, 1, self.device)
        self.mesh = mesh
        # The batch (data) axis size rounds the buckets and places the
        # rows; the model axis splits the heads; n_devices is every rank.
        self.dp = shd.axis_size(mesh, "data") if mesh else 1
        self.mp = shd.axis_size(mesh, "model") if mesh else 1
        self.n_devices = mesh.size if mesh else 1
        self._replica_id = None
        if mesh is not None:
            # Only the tree this mode serves goes to the ranks.
            tree = qparams if self.mode == "int8" else params
            self._replica_id, _ = mesh_lib.create(
                mesh, MeshReplica, to_device(tree, "cpu"),
                calibrator.to("cpu") if calibrator is not None else None,
                mesh)
            weakref.finalize(self, mesh.world.release, self._replica_id)
        self.cfg = cfg
        self.params = params
        self.qparams = qparams
        self.calibrator = calibrator
        self.model_name = model_name or cfg.name
        self.buckets = round_buckets(sc.buckets, self.dp)
        if self.mp > 1 and 1 in sc.buckets and self.buckets[0] != 1:
            # The batch-1 latency path: the single image replicates over
            # ``data`` while the model axis still splits the heads.
            self.buckets = (1,) + self.buckets
        # Fused or per-phase schedule, and the group size, per bucket: the
        # config's own fields, or the policy's decisions from measured
        # (model, mode, batch) data.  An unfused bucket has group size 1.
        self.fusion_policy = sc.fusion_policy
        if sc.fusion_policy is None:
            fused = {b: bool(cfg.fused) for b in self.buckets}
            group = {b: int(cfg.fuse_group) for b in self.buckets}
        else:
            fused = sc.fusion_policy.decisions(self.model_name, self.mode,
                                               self.buckets)
            group = sc.fusion_policy.group_decisions(
                self.model_name, self.mode, self.buckets)
        self._bucket_cfg = {
            b: dataclasses.replace(cfg, fused=f,
                                   fuse_group=group[b] if f else 1)
            for b, f in fused.items()}
        self.queue: List[VisionRequest] = []
        self.done: List[VisionRequest] = []
        self.n_batches = 0
        self.n_padded = 0
        self.device_ms: List[float] = []   # per micro-batch, on the card
        self._rid = 0

    @property
    def mesh_shape(self) -> str:
        """``"DxM"``: data-axis by model-axis size (``"1x1"``: no mesh),
        the join key the rows carry."""
        return f"{self.dp}x{self.mp}"

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images on the server's device (on a mesh: any
        device) -> (B, classes) on the server's device, through the
        schedule the bucket of size B is served with."""
        cfg = self._bucket_cfg.get(images.shape[0], self.cfg)
        if self.mesh is not None:
            return mesh_lib.invoke(self.mesh, self._replica_id, "forward",
                                   cfg, images.cpu())
        patches = vit.extract_patches(images, cfg.patch)
        fwd = vision_registry.forward_fn(cfg)
        if self.mode == "int8":
            return fwd(self.qparams, patches, cfg, observer=self.calibrator)
        return fwd(self.params, patches, cfg)

    # -- request plane ----------------------------------------------------

    def submit(self, image: np.ndarray) -> VisionRequest:
        req = VisionRequest(self._rid, np.asarray(image, np.float32))
        self._rid += 1
        self.queue.append(req)
        return req

    def submit_many(self, images: np.ndarray) -> List[VisionRequest]:
        return [self.submit(im) for im in images]

    # -- execution plane --------------------------------------------------

    def _bucket_for(self, k: int) -> int:
        for b in self.buckets:
            if b >= k:
                return b
        return self.buckets[-1]

    def _stage(self, requests: List[VisionRequest],
               bucket: int) -> torch.Tensor:
        """The micro-batch's images, padded with zeros to ``bucket``, in a
        fresh host tensor (pinned for the card: its copy then runs
        asynchronously, and the caching host allocator hands the block out
        again only once that copy has completed)."""
        with trace.span("vita.server.stage") as sp:
            first = requests[0].image
            host = torch.empty((bucket,) + first.shape, dtype=torch.float32,
                               pin_memory=self.device.type == "cuda")
            buf = host.numpy()
            np.stack([r.image for r in requests], out=buf[:len(requests)])
            buf[len(requests):] = 0.0
            if trace.ON:
                sp.set(buf.nbytes)
        return host

    def dispatch(self, requests: Optional[List[VisionRequest]] = None,
                 bucket: Optional[int] = None) -> Optional[InFlight]:
        """Assemble one micro-batch (default: up to ``buckets[-1]`` from the
        queue), pad it to its bucket and launch the forward without
        waiting for it: on the card nothing here waits for the device, so
        the caller may dispatch the next micro-batch while this one runs.
        ``bucket`` defaults to the smallest bucket that fits; the
        admission layer passes its own pick."""
        if requests is None:
            if not self.queue:
                return None
            take = min(len(self.queue), self.buckets[-1])
            requests, self.queue = self.queue[:take], self.queue[take:]
        elif not requests:
            return None
        bucket = self._bucket_for(len(requests)) if bucket is None \
            else int(bucket)
        if len(requests) > bucket:
            raise ValueError(
                f"{len(requests)} requests cannot ride a {bucket}-bucket")
        with trace.span("vita.server.dispatch", trace.OWN, bucket,
                        len(requests)) as sp:
            if trace.ON:
                for req in requests:
                    req.batch = sp.id
            host = self._stage(requests, bucket)
            self.n_padded += bucket - len(requests)
            # Events time single-device forwards; a mesh forward has
            # waited for its ranks by the time it returns.
            on_card = self.device.type == "cuda" and self.mesh is None
            start = event = None
            t = time.perf_counter()
            for req in requests:
                req.t_start = t
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            with torch.inference_mode():
                with trace.span("vita.server.copy"):
                    x = host if self.mesh is not None else \
                        host.to(self.device, non_blocking=on_card)
                with trace.launch_span("vita.server.forward"):
                    out = self.forward(x)
            copied = None
            if on_card:
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                # The read-back, queued behind this forward and ahead of
                # the next micro-batch's kernels.
                out = torch.empty(out.shape, dtype=out.dtype,
                                  pin_memory=True).copy_(out,
                                                         non_blocking=True)
                copied = torch.cuda.Event()
                copied.record()
            self.n_batches += 1
            return InFlight(requests, bucket, out, event, start, t, sp.id,
                            copied)

    def complete(self, inflight: Optional[InFlight]) -> int:
        """Wait for an in-flight micro-batch and stamp its requests done;
        returns the number of requests served."""
        if inflight is None:
            return 0
        copied = inflight.copied
        with trace.span("vita.server.complete", inflight.batch):
            with trace.span("vita.server.wait") as sp:
                if copied is not None:
                    if trace.ON:
                        sp.set(int(not copied.query()))
                    copied.synchronize()
            if inflight.event is not None:
                self.device_ms.append(
                    inflight.start.elapsed_time(inflight.event))
            with trace.span("vita.server.readback") as sp:
                logits = inflight.out.cpu().numpy()
                if copied is not None:
                    # Out of the pinned block, so the allocator may reuse
                    # it while these requests' logits live on.
                    logits = logits.copy()
                    sp.set(1)
                t = time.perf_counter()
                for i, req in enumerate(inflight.requests):
                    req.t_done = t
                    req.logits = logits[i]
                    req.pred = int(np.argmax(logits[i]))
            self.done.extend(inflight.requests)
            return len(inflight.requests)

    def step(self) -> int:
        return self.complete(self.dispatch())

    def profile_stats(self, batch: Optional[int] = None, *,
                      warmup: int = 1, repeats: int = 2) -> Dict:
        """Profile one micro-batch of zeros through the per-phase replay
        (`core.schedule.profile_schedule`) and return the live HUE report
        of this server's (model, mode): measured ms per phase kind beside
        the analytic `perfmodel` attribution.  ``batch`` defaults to the
        smallest bucket; the schedule profiled (fused, unfused or grouped)
        is the one this server serves that bucket with.  The queue and the
        stats counters are left alone.  On a mesh it profiles rank 0's
        single-device replay of the whole tree (per-phase attribution,
        not mesh latency: the drain stats carry that)."""
        bucket = int(batch) if batch else self.buckets[0]
        cfg = self._bucket_cfg.get(bucket)
        if cfg is None:
            pol = self.fusion_policy
            fused = (pol.decide(self.model_name, self.mode, bucket) if pol
                     else bool(self.cfg.fused))
            group = (pol.decide_group(self.model_name, self.mode, bucket)
                     if pol else int(self.cfg.fuse_group))
            cfg = dataclasses.replace(self.cfg, fused=fused,
                                      fuse_group=group if fused else 1)
        int8 = self.mode == "int8"
        images = torch.zeros((bucket, cfg.image, cfg.image, 3),
                             device=self.device)
        _, records = sched_lib.profile_schedule(
            vision_registry.make_schedule(cfg),
            self.qparams if int8 else self.params,
            vit.extract_patches(images, cfg.patch),
            observer=self.calibrator if int8 else None,
            warmup=warmup, repeats=repeats)
        report = hue_lib.live_hue_report(
            vision_registry.make_spec(cfg), records, fused=bool(cfg.fused),
            group_size=int(cfg.fuse_group))
        report.update({"model": self.model_name, "config": cfg.name,
                       "mode": self.mode, "batch": bucket,
                       "fused": bool(cfg.fused),
                       "group_size": int(cfg.fuse_group),
                       "devices": self.n_devices,
                       "mesh_shape": self.mesh_shape,
                       "device": str(self.device)})
        return report

    def restamp_queued(self) -> None:
        """Reset queued requests' submit clocks (after a warm-up drain, so
        reported latencies are steady-state).  Drain mode only: the open
        stream stamps queue delay and service time apart."""
        t = time.perf_counter()
        for r in self.queue:
            r.t_submit = t

    def run(self) -> Dict[str, float]:
        """Drain the whole queue and return this run's serving statistics."""
        batches0, padded0, done0 = self.n_batches, self.n_padded, \
            len(self.done)
        device0 = len(self.device_ms)
        t0 = time.perf_counter()
        served = 0
        while self.queue:
            served += self.step()
        dt = time.perf_counter() - t0
        reqs = self.done[done0:]
        lat_ms = np.array([r.latency_s for r in reqs]) * 1e3
        queue_ms = np.array([r.queue_delay_s for r in reqs]) * 1e3
        service_ms = np.array([r.service_s for r in reqs]) * 1e3

        def pct(a, q):
            return float(np.percentile(a, q)) if served else 0.0

        return {
            "mode": self.mode,
            "device": str(self.device),
            "devices": self.n_devices,
            "mesh_shape": self.mesh_shape,
            "requests": served,
            "batches": self.n_batches - batches0,
            "padded": self.n_padded - padded0,
            "wall_s": dt,
            "throughput_img_s": served / dt if dt > 0 else 0.0,
            "latency_p50_ms": pct(lat_ms, 50),
            "latency_p99_ms": pct(lat_ms, 99),
            "latency_mean_ms": float(lat_ms.mean()) if served else 0.0,
            "queue_delay_p50_ms": pct(queue_ms, 50),
            "service_p50_ms": pct(service_ms, 50),
            "device_p50_ms": (float(np.percentile(self.device_ms[device0:],
                                                  50))
                              if len(self.device_ms) > device0 else None),
            "fusion_policy": (self.fusion_policy.mode
                              if self.fusion_policy else None),
            "fused_buckets": {str(b): bool(c.fused)
                              for b, c in sorted(self._bucket_cfg.items())},
            "group_buckets": {str(b): int(c.fuse_group)
                              for b, c in sorted(self._bucket_cfg.items())},
        }


# ---------------------------------------------------------------------------
# Calibration helper + construction path + CLI
# ---------------------------------------------------------------------------


def calibrate(qparams, cfg, images: np.ndarray, *,
              device, n_batches: int = 4) -> Calibrator:
    """Run calibration forwards on ``device`` and freeze the activation
    scales there.  The forward is the config family's, so Swin calibrates
    through the windowed int8 path it serves with, and TNT records the
    sites of both streams (``pixel_embed``, ``l{i}.inner.*``,
    ``l{i}.fold``) under the reference's names."""
    fwd = vision_registry.forward_fn(cfg)
    cal = Calibrator()
    with torch.inference_mode():
        for chunk in np.array_split(images, n_batches):
            if len(chunk) == 0:
                continue
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
            fwd(qparams, vit.extract_patches(x, cfg.patch), cfg,
                observer=cal)
    cal.freeze(device)
    return cal


def make_server(cfg_name: str, serve_cfg: Optional[ServeConfig] = None, *,
                params=None, qparams=None,
                calibrator: Optional[Calibrator] = None,
                calib_bank: Optional[np.ndarray] = None) -> VisionServer:
    """Build a ready `VisionServer` for a registered model name on
    ``serve_cfg.device`` (None = the card): resolve the config through
    ``full``, ``fused``, ``fuse_group`` and ``head_mask``, init params at
    ``serve_cfg.seed`` unless given, and for int8 quantize and calibrate
    (on ``calib_bank`` or ``calib_images`` synthetic images drawn exactly
    as the JAX server draws them) unless a frozen calibrator is given."""
    sc = serve_cfg if serve_cfg is not None else ServeConfig()
    device = resolve_device(sc.device)
    cfg = vision_registry.build_cfg(cfg_name, full=sc.full, fused=sc.fused,
                                    fuse_group=sc.fuse_group,
                                    head_mask=sc.head_mask)
    if params is None:
        params = vision_registry.init_params(cfg, sc.seed, device)
    if sc.mode == "int8":
        if qparams is None:
            qparams = vision_registry.quantize(vit.to_device(params, device))
        if calibrator is None:
            bank = calib_bank
            if bank is None:
                rng = np.random.default_rng(sc.seed)
                bank = rng.standard_normal(
                    (sc.calib_images, cfg.image, cfg.image, 3)
                ).astype(np.float32)
            calibrator = calibrate(vit.to_device(qparams, device), cfg, bank,
                                   device=device)
    return VisionServer(cfg, params, serve_cfg=sc, qparams=qparams,
                        calibrator=calibrator, model_name=cfg_name)


def build_edge_vit(image: int = 32, patch: int = 8, dim: int = 96,
                   heads: int = 4, layers: int = 4,
                   n_classes: int = 10) -> vit.ViTConfig:
    """A custom edge ViT (the registry's ``vit_edge`` covers the default
    geometry; this one is for tests and ad-hoc configs)."""
    return vit.ViTConfig(name=f"vit_edge_{image}", image=image, patch=patch,
                         dim=dim, heads=heads, layers=layers,
                         n_classes=n_classes)


def hue_table(report: Dict, title: str) -> str:
    """`core.hue.render_hue_table` with the note on what its HUEmeas%
    column means on a device faster than ViTA."""
    return (hue_lib.render_hue_table(report, title=title) + "\n"
            + hue_lib.HUE_MEASURED_NOTE)


def _mesh_ranks(devices: int = 1, mesh_shape=None) -> int:
    """Ranks a (``devices``, ``mesh_shape``) request needs; ``mesh_shape``
    wins, as in `VisionServer`."""
    if mesh_shape is not None:
        d, m = mesh_lib.parse_mesh_shape(mesh_shape)
        return d * m
    return max(int(devices), 1)


def serve_model(name: str, *, requests: int, buckets, modes, full: bool,
                seed: int = 0, calib_images: int = 8, device=None,
                devices: int = 1, mesh_shape=None,
                fused: Optional[bool] = None, fuse_group: int = 1,
                fusion_policy: Optional[FusionPolicy] = None,
                profile: bool = False) -> List[Dict[str, float]]:
    """Init params once, (for int8) quantize and calibrate on the first
    ``calib_images`` request images, and drain ``requests`` random images
    through a server per mode.  ``fused`` overrides the config's fusion
    and ``fuse_group`` its group size; ``fusion_policy`` decides both per
    bucket.  ``devices`` > 1 shards each drain's batch over that many
    ranks, ``mesh_shape`` ("DxM") builds the 2-D latency mesh instead
    (`launch.mesh.launch_mesh` starts the ranks unless a world exists;
    calibration stays on rank 0's device).  ``profile`` also runs
    `VisionServer.profile_stats` after each mode's drain, prints its HUE
    table and attaches the report to the row (``hue_profile``).  One
    stats row per mode (None on the other ranks under torchrun)."""
    dev = resolve_device(device)

    def body():
        cfg = vision_registry.build_cfg(name, full=full, fused=fused,
                                        fuse_group=fuse_group)
        params = vision_registry.init_params(cfg, seed, dev)
        rng = np.random.default_rng(seed)
        images = rng.standard_normal(
            (requests, cfg.image, cfg.image, 3)).astype(np.float32)
        qparams = cal = None
        if "int8" in modes:
            qparams = vision_registry.quantize(params)
            cal = calibrate(qparams, cfg, images[:calib_images], device=dev)
        rows = []
        for mode in modes:
            sc = ServeConfig(mode=mode, buckets=tuple(buckets),
                             data_parallel=devices, mesh_shape=mesh_shape,
                             fusion_policy=fusion_policy, full=full,
                             fused=fused, fuse_group=fuse_group, seed=seed,
                             calib_images=calib_images, device=str(dev))
            server = VisionServer(cfg, params, serve_cfg=sc, qparams=qparams,
                                  calibrator=cal, model_name=name)
            server.submit_many(images)
            stats = server.run()
            stats.update({"model": name, "config": cfg.name})
            rows.append(stats)
            print(f"[vision-serve] {cfg.name} mode={mode} on "
                  f"{stats['device']} mesh={stats['mesh_shape']} "
                  f"devices={stats['devices']}: {stats['requests']} reqs in "
                  f"{stats['wall_s']:.3f}s -> "
                  f"{stats['throughput_img_s']:.1f} img/s, "
                  f"p50 {stats['latency_p50_ms']:.2f}ms "
                  f"({stats['batches']} batches, {stats['padded']} padded; "
                  f"fused buckets {stats['fused_buckets']}, group sizes "
                  f"{stats['group_buckets']})")
            if profile:
                report = server.profile_stats()
                stats["hue_profile"] = report
                print(hue_table(report, f"{name} ({cfg.name}) mode={mode} "
                                        f"fused={report['fused']} "
                                        f"batch={report['batch']} on "
                                        f"{report['device']}"))
        return rows

    ranks = _mesh_ranks(devices, mesh_shape)
    return body() if ranks == 1 else \
        mesh_lib.launch_mesh(body, ranks, 1, dev)


def serve_stream(model_names: Sequence[str], *, modes: Sequence[str],
                 buckets: Sequence[int], trace, serving: str = "continuous",
                 seed: int = 0, calib_images: int = 8, devices: int = 1,
                 mesh_shape=None, latency_mesh=None,
                 fusion_policy: Optional[FusionPolicy] = None,
                 bench_data=None, full: bool = False,
                 max_inflight: int = 2, device=None
                 ) -> List[Dict[str, float]]:
    """Open-stream serving: replay an arrival ``trace``
    (`launch.admission.Arrival` list) through the continuous-batching
    admission layer (``serving="continuous"``) or the fixed-bucket drain
    baseline (``serving="drain"``, a single model).  One `VisionServer`
    per model of ``model_names`` shares the devices, on the ``devices``
    / ``mesh_shape`` mesh as in `serve_model`; ``latency_mesh`` ("DxM")
    also builds a batch-1 server per model on that mesh, which
    tight-deadline singles route to (the controller's
    ``routed_latency_path``).  The SLA bucket tables come from
    ``bench_data`` (a bench record or its path, rows of the server's
    ``mesh_shape``) when the caller passes one, else from a live
    measurement.  One stats row per mode (None on the other ranks under
    torchrun)."""
    from repro_torch.launch import admission as adm
    if serving not in ("continuous", "drain"):
        raise ValueError(f"serving must be 'continuous' or 'drain', got "
                         f"{serving!r}")
    dev = resolve_device(device)

    def body():
        rows = []
        for mode in modes:
            servers, lat_servers, banks, tables = {}, {}, {}, {}
            for nm in model_names:
                cfg = vision_registry.build_cfg(nm, full=full)
                params = vision_registry.init_params(cfg, seed, dev)
                banks[nm] = np.random.default_rng(seed).standard_normal(
                    (calib_images, cfg.image, cfg.image, 3)
                ).astype(np.float32)
                qparams = cal = None
                if mode == "int8":
                    qparams = vision_registry.quantize(params)
                    cal = calibrate(qparams, cfg, banks[nm], device=dev)
                sc = ServeConfig(mode=mode, buckets=tuple(buckets),
                                 data_parallel=devices,
                                 mesh_shape=mesh_shape,
                                 fusion_policy=fusion_policy,
                                 device=str(dev))
                servers[nm] = VisionServer(cfg, params, serve_cfg=sc,
                                           qparams=qparams, calibrator=cal,
                                           model_name=nm)
                if latency_mesh is not None:
                    lat_sc = dataclasses.replace(
                        sc, buckets=(1,), data_parallel=None,
                        mesh_shape=latency_mesh)
                    lat_servers[nm] = VisionServer(
                        cfg, params, serve_cfg=lat_sc, qparams=qparams,
                        calibrator=cal, model_name=nm)
                if bench_data is not None:
                    table = adm.latency_table_from_bench(
                        bench_data, nm, mode,
                        mesh_shape=servers[nm].mesh_shape)
                    if table:
                        tables[nm] = table
            if serving == "drain":
                if len(servers) != 1:
                    raise ValueError("the drain baseline serves a single "
                                     "model")
                (nm, server), = servers.items()
                adm.measure_bucket_latencies(server)   # warm every bucket
                stats = adm.run_drain_stream(server, trace, banks)
                stats["model"] = nm
            else:
                controller = adm.AdmissionController(
                    servers, latencies=tables or None,
                    latency_servers=lat_servers or None,
                    max_inflight=max_inflight)
                stats = adm.run_open_stream(controller, trace, banks)
                stats["model"] = ",".join(model_names)
            server = next(iter(servers.values()))
            stats.update({"mode": mode, "serving": serving,
                          "device": str(server.device),
                          "devices": server.n_devices,
                          "mesh_shape": server.mesh_shape,
                          "latency_mesh": (lat_servers[model_names[0]]
                                           .mesh_shape if lat_servers
                                           else None),
                          "offered": len(trace)})
            rows.append(stats)
            print(f"[vision-serve] stream {stats['model']} mode={mode} "
                  f"serving={serving} on {stats['device']} "
                  f"mesh={stats['mesh_shape']} latency mesh="
                  f"{stats['latency_mesh']}: "
                  f"{stats['requests']} reqs in {stats['wall_s']:.2f}s -> "
                  f"{stats['throughput_img_s']:.1f} img/s sustained, "
                  f"p50 {stats['latency_p50_ms']:.1f}ms "
                  f"p95 {stats['latency_p95_ms']:.1f}ms "
                  f"p99 {stats['latency_p99_ms']:.1f}ms "
                  f"(queue p50 {stats['queue_delay_p50_ms']:.1f}ms, "
                  f"sla misses {stats['sla_misses']}, routed to the latency "
                  f"path {stats.get('routed_latency_path', 0)})")
        return rows

    ranks = max(_mesh_ranks(devices, mesh_shape),
                _mesh_ranks(1, latency_mesh))
    return body() if ranks == 1 else \
        mesh_lib.launch_mesh(body, ranks, 1, dev)


def _device_name(device) -> str:
    """The card's name, or ``cpu``: what a written record says it ran on."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _write_json(path: str, record: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    print(f"[vision-serve] wrote {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="vision_serve",
        description="Serve a registered vision model through the port's "
                    "batched ViTA pipeline.")
    ap.add_argument("--model", default="vit_edge",
                    help="registered model (see --list-models); open-stream "
                         "runs (--arrival-rate / --trace) take a "
                         "comma-separated list, one lane per model")
    ap.add_argument("--list-models", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="the paper-scale geometry instead of the reduced one")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--buckets", default="1,2,4,8")
    ap.add_argument("--mode", choices=("float", "int8", "both"),
                    default="both")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    ap.add_argument("--no-fuse", action="store_true",
                    help="serve the per-phase schedule (msa + mlp phases) "
                         "instead of the fused layers; shorthand for "
                         "--fusion-policy never")
    ap.add_argument("--fusion-policy", choices=FusionPolicy.MODES,
                    default=None,
                    help="fuse or not per (model, mode, batch): 'always', "
                         "'never', or 'auto' (measured A/B data from "
                         "--fusion-data)")
    ap.add_argument("--fusion-data", default=None,
                    help="bench JSON measured on the card that seeds the "
                         "'auto' policy (no default: a record measured "
                         "elsewhere must not steer the card)")
    ap.add_argument("--fuse-group-size", type=int, default=1,
                    help="layer-group size: collapse runs of up to this "
                         "many fused layers into one layer_group kernel "
                         "launch (1 = the per-layer chain; groups form only "
                         "where members share stage, geometry and heads)")
    ap.add_argument("--profile", action="store_true",
                    help="after each mode's drain, profile one micro-batch "
                         "phase by phase and print the live HUE table "
                         "(measured against the ViTA cycle model)")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="open-stream serving: Poisson arrivals a second "
                         "through the continuous-batching admission layer "
                         "(launch/admission.py) instead of the closed drain")
    ap.add_argument("--sla-ms", type=float, default=None,
                    help="open stream: each request's latency budget (ms); "
                         "the scheduler picks each micro-batch's bucket from "
                         "measured per-batch latencies so the budget holds")
    ap.add_argument("--trace", default=None,
                    help="open stream: replay an arrival trace JSON "
                         "({'arrivals': [{'t': s, 'model'?: name, "
                         "'sla_ms'?: ms}]}) instead of Poisson arrivals")
    ap.add_argument("--serving", choices=("continuous", "drain"),
                    default="continuous",
                    help="open-stream scheduler: the admission layer "
                         "(default) or the fixed-bucket drain baseline")
    ap.add_argument("--devices", type=int, default=1,
                    help="data-parallel ranks: shard each micro-batch's "
                         "batch over this many ranks (params replicated; "
                         "buckets round up to a multiple)")
    ap.add_argument("--mesh", default=None,
                    help="2-D mesh 'DxM' (data x model), e.g. 1x3: the "
                         "batch on the data axis, the heads and MLP "
                         "columns split over the model axis; wins over "
                         "--devices")
    ap.add_argument("--latency-mesh", default=None,
                    help="open stream only: also build a batch-1 server "
                         "per model on this 'DxM' mesh; tight-deadline "
                         "singles route to it")
    ap.add_argument("--json-out", default=None,
                    help="write the stats rows as a JSON record")
    args = ap.parse_args(argv)
    if args.list_models:
        for name in vision_registry.list_models():
            entry = vision_registry.get(name)
            print(f"{name:10s} [{entry.family}] {entry.description}")
        return []
    stream = args.arrival_rate is not None or args.trace is not None
    if not stream and args.model not in vision_registry.list_models():
        raise SystemExit(f"[vision-serve] unknown model {args.model!r}; "
                         f"registered: "
                         f"{', '.join(vision_registry.list_models())} "
                         f"(comma-separated lists need --arrival-rate or "
                         f"--trace)")
    if args.no_fuse and args.fusion_policy:
        raise SystemExit("[vision-serve] --no-fuse and --fusion-policy "
                         "conflict; --no-fuse is shorthand for "
                         "--fusion-policy never")
    if args.fusion_data and args.fusion_policy != "auto":
        raise SystemExit("[vision-serve] --fusion-data seeds only "
                         "--fusion-policy auto")
    if args.fuse_group_size < 1:
        raise SystemExit("[vision-serve] --fuse-group-size must be >= 1")
    if args.devices < 1:
        raise SystemExit("[vision-serve] --devices must be >= 1")
    for flag, shape in (("--mesh", args.mesh),
                        ("--latency-mesh", args.latency_mesh)):
        if shape is not None:
            try:
                mesh_lib.parse_mesh_shape(shape)
            except ValueError as e:
                raise SystemExit(f"[vision-serve] {flag}: {e}")
    if args.latency_mesh is not None and not stream:
        raise SystemExit("[vision-serve] --latency-mesh serves open streams "
                         "only (--arrival-rate or --trace)")
    policy = None
    if args.fusion_policy == "auto" and args.fusion_data:
        policy = FusionPolicy.from_bench(
            args.fusion_data, default_group=args.fuse_group_size)
    elif args.fusion_policy:
        if args.fusion_policy == "auto":
            print("[vision-serve] --fusion-policy auto without "
                  "--fusion-data: no measurements, every bucket fuses")
        policy = FusionPolicy(mode=args.fusion_policy,
                              default_group=args.fuse_group_size)
    modes = ("float", "int8") if args.mode == "both" else (args.mode,)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    if stream:
        return _main_stream(args, modes, buckets, policy)
    rows = serve_model(args.model, requests=args.requests, buckets=buckets,
                       modes=modes, full=args.full, seed=args.seed,
                       device=args.device, devices=args.devices,
                       mesh_shape=args.mesh,
                       fused=False if args.no_fuse else None,
                       fuse_group=args.fuse_group_size,
                       fusion_policy=policy, profile=args.profile)
    if args.json_out and rows is not None:
        _write_json(args.json_out, {
            "bench": "vision_serve", "model": args.model,
            "config": rows[0]["config"], "buckets": list(buckets),
            "devices": args.devices, "mesh": args.mesh,
            "device": _device_name(args.device), "runs": rows})
    return rows


def _main_stream(args, modes, buckets, policy) -> List[Dict[str, float]]:
    """The open-stream half of the CLI: a Poisson or file trace over one
    or several models through `serve_stream`."""
    from repro_torch.launch import admission as adm
    model_arg = [m for m in args.model.split(",") if m]
    if args.trace is not None:
        trace = adm.load_trace(args.trace, model_arg[0], args.sla_ms)
    else:
        if args.arrival_rate <= 0:
            raise SystemExit("[vision-serve] --arrival-rate must be > 0")
        trace = adm.poisson_trace(
            args.arrival_rate, args.requests,
            model_arg if len(model_arg) > 1 else model_arg[0],
            sla_ms=args.sla_ms, seed=args.seed)
    names = sorted({a.model for a in trace})
    unknown = sorted(set(names) - set(vision_registry.list_models()))
    if unknown:
        raise SystemExit(f"[vision-serve] trace names unregistered "
                         f"model(s): {', '.join(unknown)}")
    rows = serve_stream(names, modes=modes, buckets=buckets, trace=trace,
                        serving=args.serving, seed=args.seed,
                        devices=args.devices, mesh_shape=args.mesh,
                        latency_mesh=args.latency_mesh,
                        fusion_policy=policy, bench_data=args.fusion_data,
                        full=args.full, device=args.device)
    if args.json_out and rows is not None:
        _write_json(args.json_out, {
            "bench": "vision_serve_stream", "models": names,
            "serving": args.serving, "arrival_rate": args.arrival_rate,
            "sla_ms": args.sla_ms, "trace": args.trace,
            "buckets": list(buckets), "devices": args.devices,
            "mesh": args.mesh, "latency_mesh": args.latency_mesh,
            "device": _device_name(args.device), "runs": rows})
    return rows


if __name__ == "__main__":
    main()

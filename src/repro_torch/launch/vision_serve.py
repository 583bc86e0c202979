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
``service_s`` spans the host's launches and the device's work; on the
card it records a CUDA event before and after the forward without
waiting, and `complete` waits on the second and keeps the device time
between them (``device_p50_ms`` of `run`).  On the CPU the forward
completes inside `dispatch`.  The server runs on the card
unless ``ServeConfig(device="cpu")`` asks otherwise.

Usage (on a machine with a card; ``--device cpu`` runs the plain path):
  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model deit_t \
      --full --mode both
  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model swin_t \
      --full --mode both --no-fuse
  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model tnt_s \
      --full --mode both
  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model deit_t \
      --full --mode both --fuse-group-size 4
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant import Calibrator
from repro_torch.core.schedule import FusionPolicy
from repro_torch.models import vision_registry, vit


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raises when the card is asked for and
    there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch path on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """How a model is served: mode, batch buckets, an optional per-bucket
    `FusionPolicy`, the build fields `make_server` reads (``full``,
    ``fused``, ``fuse_group``, ``head_mask``, ``seed``, ``calib_images``)
    and the device (None = the card).  ``fused``, ``fuse_group`` and
    ``head_mask`` None keep the registry config's own fields (fused,
    ungrouped, the entry's mask)."""

    mode: str = "float"
    buckets: Tuple[int, ...] = (1, 2, 4, 8)
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
    """One queued request, stamped at submit, dispatch and completion."""

    def __init__(self, rid: int, image: np.ndarray):
        self.rid = rid
        self.image = image
        self.t_submit = time.perf_counter()
        self.t_start: Optional[float] = None
        self.t_done: Optional[float] = None
        self.pred: Optional[int] = None
        self.logits: Optional[np.ndarray] = None

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


class InFlight:
    """A dispatched micro-batch: its logits tensor and, on the card, the
    CUDA events recorded before (``start``) and after (``event``) its
    forward."""

    __slots__ = ("requests", "bucket", "out", "event", "start")

    def __init__(self, requests: List[VisionRequest], bucket: int,
                 out: torch.Tensor, event, start=None):
        self.requests = requests
        self.bucket = bucket
        self.out = out
        self.event = event
        self.start = start


class VisionServer:
    """Queue + pad-to-bucket micro-batching over a registered vision
    config (ViT/DeiT, Swin or TNT)."""

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
        self.cfg = cfg
        self.params = params
        self.qparams = qparams
        self.calibrator = calibrator
        self.model_name = model_name or cfg.name
        self.buckets = sc.buckets
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

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images on the server's device -> (B, classes),
        through the schedule the bucket of size B is served with."""
        cfg = self._bucket_cfg.get(images.shape[0], self.cfg)
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

    def dispatch(self, requests: Optional[List[VisionRequest]] = None,
                 bucket: Optional[int] = None) -> Optional[InFlight]:
        """Assemble one micro-batch (default: up to ``buckets[-1]`` from the
        queue), pad it to its bucket and launch the forward without
        waiting for it."""
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
        images = np.stack([r.image for r in requests])
        if bucket > len(requests):
            pad = np.zeros((bucket - len(requests),) + images.shape[1:],
                           images.dtype)
            images = np.concatenate([images, pad])
            self.n_padded += bucket - len(requests)
        on_card = self.device.type == "cuda"
        start = event = None
        t = time.perf_counter()
        for req in requests:
            req.t_start = t
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        with torch.inference_mode():
            out = self.forward(torch.from_numpy(images).to(self.device))
        if on_card:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        self.n_batches += 1
        return InFlight(requests, bucket, out, event, start)

    def complete(self, inflight: Optional[InFlight]) -> int:
        """Wait for an in-flight micro-batch and stamp its requests done;
        returns the number of requests served."""
        if inflight is None:
            return 0
        if inflight.event is not None:
            inflight.event.synchronize()
            self.device_ms.append(inflight.start.elapsed_time(inflight.event))
        logits = inflight.out.cpu().numpy()
        t = time.perf_counter()
        for i, req in enumerate(inflight.requests):
            req.t_done = t
            req.logits = logits[i]
            req.pred = int(np.argmax(logits[i]))
        self.done.extend(inflight.requests)
        return len(inflight.requests)

    def step(self) -> int:
        return self.complete(self.dispatch())

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
        service_ms = np.array([r.service_s for r in reqs]) * 1e3

        def pct(a, q):
            return float(np.percentile(a, q)) if served else 0.0

        return {
            "mode": self.mode,
            "device": str(self.device),
            "requests": served,
            "batches": self.n_batches - batches0,
            "padded": self.n_padded - padded0,
            "wall_s": dt,
            "throughput_img_s": served / dt if dt > 0 else 0.0,
            "latency_p50_ms": pct(lat_ms, 50),
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


def serve_model(name: str, *, requests: int, buckets, modes, full: bool,
                seed: int = 0, calib_images: int = 8, device=None,
                fused: Optional[bool] = None, fuse_group: int = 1,
                fusion_policy: Optional[FusionPolicy] = None
                ) -> List[Dict[str, float]]:
    """Init params once, (for int8) quantize and calibrate on the first
    ``calib_images`` request images, and drain ``requests`` random images
    through a server per mode.  ``fused`` overrides the config's fusion
    and ``fuse_group`` its group size; ``fusion_policy`` decides both per
    bucket.  One stats row per mode."""
    dev = resolve_device(device)
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
                         fusion_policy=fusion_policy, full=full,
                         fused=fused, fuse_group=fuse_group, seed=seed,
                         calib_images=calib_images, device=str(dev))
        server = VisionServer(cfg, params, serve_cfg=sc, qparams=qparams,
                              calibrator=cal, model_name=name)
        server.submit_many(images)
        stats = server.run()
        stats.update({"model": name, "config": cfg.name})
        rows.append(stats)
        print(f"[vision-serve] {cfg.name} mode={mode} on {stats['device']}: "
              f"{stats['requests']} reqs in {stats['wall_s']:.3f}s -> "
              f"{stats['throughput_img_s']:.1f} img/s, "
              f"p50 {stats['latency_p50_ms']:.2f}ms "
              f"({stats['batches']} batches, {stats['padded']} padded; "
              f"fused buckets {stats['fused_buckets']}, group sizes "
              f"{stats['group_buckets']})")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="vision_serve",
        description="Serve a registered vision model through the port's "
                    "batched ViTA pipeline.")
    ap.add_argument("--model", default="vit_edge")
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
    args = ap.parse_args(argv)
    if args.list_models:
        for name in vision_registry.list_models():
            entry = vision_registry.get(name)
            print(f"{name:10s} [{entry.family}] {entry.description}")
        return []
    if args.model not in vision_registry.list_models():
        raise SystemExit(f"[vision-serve] unknown model {args.model!r}; "
                         f"registered: "
                         f"{', '.join(vision_registry.list_models())}")
    if args.no_fuse and args.fusion_policy:
        raise SystemExit("[vision-serve] --no-fuse and --fusion-policy "
                         "conflict; --no-fuse is shorthand for "
                         "--fusion-policy never")
    if args.fusion_data and args.fusion_policy != "auto":
        raise SystemExit("[vision-serve] --fusion-data seeds only "
                         "--fusion-policy auto")
    if args.fuse_group_size < 1:
        raise SystemExit("[vision-serve] --fuse-group-size must be >= 1")
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
    return serve_model(args.model, requests=args.requests, buckets=buckets,
                       modes=modes, full=args.full, seed=args.seed,
                       device=args.device,
                       fused=False if args.no_fuse else None,
                       fuse_group=args.fuse_group_size,
                       fusion_policy=policy)


if __name__ == "__main__":
    main()

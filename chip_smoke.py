"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build every kernel from src/repro_torch/csrc (one nvcc per source, in
     parallel);
  2. hold each kernel against its plain PyTorch version on the card, at
     DeiT-T full width with batch 8, and the two layer kernels also at
     ViT-B/16 layer widths with batch 2;
  3. serve DeiT-T (224 px, 12 layers, random weights from a seed) in float
     through make_server on the card, check the logits against the same
     server on the CPU and the launch counts of the kernels;
  4. the same in int8 PTQ, calibrated on the card; the CPU twin reuses the
     frozen calibrator;
  5. time each kernel, its plain version and a library yardstick, and the
     served throughput per mode.

The line before the last is one JSON object with a record per kernel; the
last line is {"ok": true, "device": {...}}.  Without a card, or without
the repository's sources beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense), used for bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12          # fp32 outside the tensor cores
INT8_OP_PER_S = 1979e12          # int8 tensor-core peak

B_MAIN = 8                       # the largest serving bucket
N_REQUESTS = 19                  # 8 + 8 + 3: a ragged tail padded to 4
BUCKETS = (1, 2, 4, 8)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn``: the kernels and copies it
    runs on the card, summed by torch.profiler over ``iters`` calls.  Gaps
    in which the device waits for the host do not count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        fail("the profiler saw no device time")
    return us / iters / 1e3


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time per call of ``fn`` over ``iters`` calls between two CUDA
    events: device time where the card outruns the host's launches,
    otherwise the host's launch rate."""
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(flops_f32: float = 0.0, ops_i8: float = 0.0, nbytes: float = 0.0):
    """(bound_ms, bound_by): the larger of the compute time at peak for
    each operand type and the bytes over the memory rate."""
    t_ops = flops_f32 / FP32_FLOP_PER_S + ops_i8 / INT8_OP_PER_S
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                    else "bytes")


def argmax_check(got: np.ndarray, want: np.ndarray, err: float):
    """(rows whose argmax differs, whether each of them is a near-tie).

    A difference of at most ``err`` can move the argmax of a row only
    where the reference's top two values lie within 2 * err, so a differing
    argmax is allowed there and nowhere else."""
    got = got.reshape(-1, got.shape[-1])
    want = want.reshape(-1, want.shape[-1])
    differ = got.argmax(1) != want.argmax(1)
    top2 = np.sort(want, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) <= 2 * err
    return int(differ.sum()), bool(np.all(near_tie[differ]))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# Kernel inputs at the main path's shapes
# ---------------------------------------------------------------------------


def layer_inputs(cfg, b: int, seed: int):
    """Layer-0 float weights of ``cfg`` from its init, an input of unit
    scale, their int8 quantization, and act scales from max-abs
    statistics of the plain float layer on that input."""
    from repro_torch.core.quant import INT8_MAX, quantize_vision_params
    from repro_torch.kernels import ref
    from repro_torch.models import vit

    one = vit.ViTConfig(name=cfg.name, image=cfg.image, patch=cfg.patch,
                        dim=cfg.dim, heads=cfg.heads, layers=1,
                        n_classes=cfg.n_classes)
    bp = vit.init_params(one, seed, "cuda")["layers"][0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    for k in ("ln1_b", "ln2_b", "b_up", "b_down"):
        bp[k] = bp[k] + 0.1 * torch.randn(bp[k].shape, generator=g,
                                          device="cuda")
    x = torch.randn((b, cfg.tokens, cfg.dim), generator=g, device="cuda")
    f_args = (x, bp["wq"], bp["wk"], bp["wv"], bp["w_msa"], bp["ln1_w"],
              bp["ln1_b"], bp["ln2_w"], bp["ln2_b"], bp["w_up"], bp["b_up"],
              bp["w_down"], bp["b_down"])
    h, dh = cfg.heads, cfg.head_dim
    z = ref.layer_norm_ref(x, bp["ln1_w"], bp["ln1_b"])
    qkv = torch.matmul(z, ref._merge_qkv(bp["wq"], bp["wk"], bp["wv"]))
    sa = ref._attend_heads(*ref._split_qkv(qkv, h, dh), dh)
    h1 = x + sa @ bp["w_msa"]
    z2 = ref.layer_norm_ref(h1, bp["ln2_w"], bp["ln2_b"])
    hid = ref.gelu(z2 @ bp["w_up"] + bp["b_up"])
    acts = torch.stack([t.abs().amax() for t in (z, sa, z2, hid)]) / INT8_MAX
    q = quantize_vision_params(bp)
    i_args = (x, q["wq"].values, q["wk"].values, q["wv"].values,
              q["w_msa"].values, q["w_up"].values, q["w_down"].values,
              acts.float().contiguous(),
              *[q[k].scale.reshape(h, dh) for k in ("wq", "wk", "wv")],
              *[q[k].scale.reshape(-1) for k in ("w_msa", "w_up", "w_down")],
              bp["ln1_w"], bp["ln1_b"], bp["ln2_w"], bp["ln2_b"], bp["b_up"],
              bp["b_down"])
    return f_args, i_args


def layer_flops(b, n, d, h, dh, m):
    """(projection/MLP matmul ops, attention ops) of one layer call."""
    proj = 2 * b * n * d * (3 * h * dh) + 2 * b * n * (h * dh) * d \
        + 2 * 2 * b * n * d * m
    attn = 2 * 2 * b * h * n * n * dh
    return proj, attn


def composed_layer(args, h: int, dh: int):
    """The float layer as a composition of library calls (cuBLAS matmuls,
    F.layer_norm, F.scaled_dot_product_attention, F.gelu) — a yardstick
    the port never calls."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    (x, wq, wk, wv, w_msa, l1w, l1b, l2w, l2b, w_up, b_up, w_down,
     b_down) = args
    wqkv = ref._merge_qkv(wq, wk, wv)
    b, n, d = x.shape

    def run():
        z = F.layer_norm(x, (d,), l1w, l1b, 1e-5)
        q, k, v = ref._split_qkv(z @ wqkv, h, dh)
        sa = F.scaled_dot_product_attention(q, k, v)
        h1 = x + sa.permute(0, 2, 1, 3).reshape(b, n, h * dh) @ w_msa
        z2 = F.layer_norm(h1, (d,), l2w, l2b, 1e-5)
        return h1 + F.gelu(z2 @ w_up + b_up, approximate="tanh") @ w_down \
            + b_down
    return run


def kernel_phase(deit, vitb):
    """Each kernel against its plain version; returns the kernel records
    (without launch counts) for the timing line."""
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import ref, vita_layer as vl, vita_msa as vm

    records = {}
    h, dh, n, d, m = deit.heads, deit.head_dim, deit.tokens, deit.dim, \
        deit.mlp_hidden

    # Float and int8 layers at DeiT-T (batch 8) and ViT-B/16 (batch 2).
    for cfg, b, tag in ((deit, B_MAIN, "deit_t"), (vitb, 2, "vit_b16")):
        f_args, i_args = layer_inputs(cfg, b, seed=1)
        got, want = vl.vita_layer(*f_args), ref.vita_layer_ref(*f_args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"[check] vita_layer {tag} B={b}: max|err| {err:.3e} "
              f"(logit scale {scale:.3f}, bound 1e-4 x max(1, scale))")
        check(err <= 1e-4 * max(1.0, scale), f"vita_layer {tag} disagrees")
        got = vl.vita_layer_int8(*i_args)
        want = ref.vita_layer_int8_ref(*i_args)
        torch.cuda.synchronize()
        err_i = float((got - want).abs().max())
        scale_i = float(want.abs().max())
        n_differ, ties = argmax_check(got.cpu().numpy(), want.cpu().numpy(),
                                      err_i)
        print(f"[check] vita_layer_int8 {tag} B={b}: max|err| {err_i:.3e} "
              f"(scale {scale_i:.3f}, bound 0.02 x scale; an LSB flip at a "
              f"requant boundary moves a value by ~one activation scale "
              f"times a weight); per-token argmax differs on {n_differ} of "
              f"{b * cfg.tokens} tokens, each a near-tie: {ties}")
        check(err_i <= 0.02 * scale_i and ties,
              f"vita_layer_int8 {tag} disagrees")
        if tag == "deit_t":
            records["vita_layer"] = dict(
                args=f_args, err=err,
                fn=lambda a=f_args: vl.vita_layer(*a),
                plain=lambda a=f_args: ref.vita_layer_ref(*a),
                library=composed_layer(f_args, h, dh))
            records["vita_layer_int8"] = dict(
                args=i_args, err=err_i,
                fn=lambda a=i_args: vl.vita_layer_int8(*a),
                plain=lambda a=i_args: ref.vita_layer_int8_ref(*a),
                library=None)
            deit_q = i_args

    # int8 MSA (the calibration pass's kernel) at DeiT-T, batch 8.
    x = deit_q[0]
    zq = torch.clamp(torch.round(x / 0.02), -127, 127).to(torch.int8)
    xs = torch.tensor(0.02, device="cuda")
    m_args = (zq, *deit_q[1:4], xs, *deit_q[8:11])
    got, want = vm.vita_msa_int8(*m_args), ref.vita_msa_int8_ref(*m_args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"[check] vita_msa_int8 deit_t B={B_MAIN}: max|err| {err:.3e} "
          f"(scale {scale:.3f}, bound 1e-4 x max(1, scale); identical int8 "
          f"inputs, fp32 softmax)")
    check(err <= 1e-4 * max(1.0, scale), "vita_msa_int8 disagrees")
    records["vita_msa_int8"] = dict(
        args=m_args, err=err, fn=lambda: vm.vita_msa_int8(*m_args),
        plain=lambda: ref.vita_msa_int8_ref(*m_args), library=None)

    # int8 matmul at the embed and head shapes, exact int32.
    g = torch.Generator(device="cuda").manual_seed(2)
    for (mm, kk, nn), tag in (((B_MAIN * n, deit.patch_dim, d), "embed"),
                              ((B_MAIN, d, deit.n_classes), "head")):
        a = torch.randint(-127, 128, (mm, kk), device="cuda", generator=g,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (kk, nn), device="cuda", generator=g,
                          dtype=torch.int8)
        ws = torch.rand(nn, device="cuda", generator=g) * 1e-2
        exact = torch.equal(im.int8_matmul(a, w), ref.int8_matmul_ref(a, w))
        got = im.int8_matmul(a, w, xs, ws)
        want = ref.int8_matmul_ref(a, w, xs, ws)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"[check] int8_matmul {tag} ({mm}x{kk})x({kk}x{nn}): int32 "
              f"equal {exact}; rescaled max|err| {err:.3e} (bound 0)")
        check(exact and err == 0.0, f"int8_matmul {tag} disagrees")
        if tag == "embed":
            records["int8_matmul"] = dict(
                args=(a, w, xs, ws), err=err,
                fn=lambda a=a, w=w: im.int8_matmul(a, w, xs, ws),
                plain=lambda a=a, w=w: ref.int8_matmul_ref(a, w, xs, ws),
                library=lambda a=a, w=w: torch._int_mm(a, w))
    torch.cuda.synchronize()

    # Bounds from this run's shapes.
    b = B_MAIN
    proj, attn = layer_flops(b, n, d, h, dh, m)
    f = records["vita_layer"]["args"]
    records["vita_layer"]["bound"] = bound(
        flops_f32=proj + attn, nbytes=nbytes(*f) + nbytes(f[0]))
    i = records["vita_layer_int8"]["args"]
    records["vita_layer_int8"]["bound"] = bound(
        ops_i8=proj, flops_f32=attn, nbytes=nbytes(*i) + nbytes(i[0]))
    ma = records["vita_msa_int8"]["args"]
    records["vita_msa_int8"]["bound"] = bound(
        ops_i8=2 * b * n * d * 3 * h * dh, flops_f32=attn,
        nbytes=nbytes(*ma) + b * h * n * dh * 4)
    a, w, xs_, ws = records["int8_matmul"]["args"]
    records["int8_matmul"]["bound"] = bound(
        ops_i8=2 * a.shape[0] * a.shape[1] * w.shape[1],
        nbytes=nbytes(a, w, xs_, ws) + a.shape[0] * w.shape[1] * 4)
    return records


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def serve_phase(mode: str, params, images, qparams=None, calibrator=None):
    """Serve ``images`` on the card (counts reset just before, read just
    after) and on the CPU twin; returns logits, counts and servers."""
    from repro_torch.kernels import ops
    from repro_torch.launch.vision_serve import ServeConfig, make_server
    from repro_torch.models import vit

    sc = ServeConfig(mode=mode, buckets=BUCKETS, full=True, seed=0)
    ops.reset_launches()
    server = make_server("deit_t", sc, params=params, qparams=qparams,
                         calibrator=calibrator)
    reqs = server.submit_many(images)
    stats = server.run()
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    gpu = np.stack([r.logits for r in reqs])
    cpu_server = make_server(
        "deit_t", ServeConfig(mode=mode, buckets=BUCKETS, full=True,
                              device="cpu"),
        params=vit.to_device(params, "cpu"),
        qparams=None if qparams is None else vit.to_device(server.qparams,
                                                           "cpu"),
        calibrator=server.calibrator)
    cpu_reqs = cpu_server.submit_many(images)
    cpu_server.run()
    cpu = np.stack([r.logits for r in cpu_reqs])
    check(gpu.shape == (len(images), 1000) and np.isfinite(gpu).all(),
          f"{mode}: logits not finite of shape ({len(images)}, 1000)")
    return gpu, cpu, counts, stats, server


def profile_drain(mode: str, server, image_shape, where: str) -> None:
    """Device busy share of a 32-request drain at bucket 8 under
    torch.profiler (which adds host time of its own), and the kernels
    that take the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    server.submit_many(np.zeros((32,) + image_shape, np.float32))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events only (kernels and copies); a host op's own
    # device total repeats its kernels' time.
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    if busy_us == 0:
        print(f"[profile] {mode}: the profiler saw no device time; busy "
              f"share not measured")
        return
    top = sorted(rows, key=lambda r: -r[1])[:6]
    print(f"[profile] served deit_t {mode} on {where}, 32 requests under "
          f"torch.profiler: device busy {busy_us / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({100 * busy_us / wall_us:.1f}% "
          f"busy); top: " + "; ".join(
              f"{k[:40]} {t / 1e3:.3f} ms x{c}" for k, t, c in top))


def main() -> None:
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device is available", file=sys.stderr)
        raise SystemExit(2)
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("[chip_smoke] src/repro_torch not found beside this script",
              file=sys.stderr)
        raise SystemExit(2)
    sys.path.insert(0, src)
    from repro_torch.core.quant import ptq_tolerance, quantize_vision_params
    from repro_torch.kernels import build
    from repro_torch.models import vision_registry, vit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {name} ({card})")

    # 1. Build.
    logs = build.build_all()
    for lib, log in sorted(logs.items()):
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {lib}: " + " | ".join(info))
    print(f"[build] {len(build.LIBRARIES)} libraries ready in "
          f"{build.BUILD_DIR}")

    # 2. Each kernel against its plain version.
    deit = vision_registry.build_cfg("deit_t", full=True)
    vitb = vision_registry.build_cfg("vit_edge", full=True)
    records = kernel_phase(deit, vitb)

    # 3. Serve float on the card against the CPU twin.
    params = vit.init_params(deit, seed=0, device="cuda")
    images = np.random.default_rng(0).standard_normal(
        (N_REQUESTS, deit.image, deit.image, 3)).astype(np.float32)
    mb = -(-N_REQUESTS // BUCKETS[-1])
    f_gpu, f_cpu, f_counts, _, f_server = serve_phase("float", params, images)
    scale = float(np.abs(f_cpu).max())
    err = float(np.abs(f_gpu - f_cpu).max())
    print(f"[serve] float: {N_REQUESTS} requests in {mb} micro-batches, "
          f"launches {f_counts}; |cuda - cpu| max {err:.3e} (logit scale "
          f"{scale:.3f}, bound 1e-3 x scale)")
    check(err <= 1e-3 * scale, "float logits disagree with the CPU twin")
    check(f_counts == {"vita_layer": 12 * mb, "vita_layer_int8": 0,
                       "vita_msa_int8": 0, "int8_matmul": 0},
          f"float launch counts {f_counts}")

    # 4. Serve int8: calibrate on the card (4 batches of 2 synthetic
    # images), the CPU twin reuses the frozen calibrator.
    qparams = quantize_vision_params(params)
    i_gpu, i_cpu, i_counts, _, i_server = serve_phase(
        "int8", params, images, qparams=qparams)
    n_cal = 4
    want = {"vita_layer": 0, "vita_layer_int8": 12 * mb,
            "vita_msa_int8": 12 * n_cal,
            "int8_matmul": n_cal * (2 + 3 * 12) + 2 * mb}
    print(f"[serve] int8: launches {i_counts} (expected {want})")
    check(i_counts == want, f"int8 launch counts {i_counts}")
    iscale = float(np.abs(i_cpu).max())
    ierr = float(np.abs(i_gpu - i_cpu).max())
    n_differ, ties = argmax_check(i_gpu, i_cpu, ierr)
    print(f"[serve] int8: |cuda - cpu| max {ierr:.3e} (scale {iscale:.3f}, "
          f"bound 0.02 x scale); argmax differs on {n_differ}/{N_REQUESTS} "
          f"requests, each a near-tie of the CPU logits: {ties}")
    check(ierr <= 0.02 * iscale and ties,
          "int8 logits disagree with the CPU twin")
    tol = ptq_tolerance(float(np.abs(f_gpu).max()))
    perr = float(np.abs(i_gpu - f_gpu).max())
    print(f"[serve] int8 vs float on the card: max|err| {perr:.4f} "
          f"(ptq_tolerance {tol:.4f})")
    check(perr <= tol, "int8 logits outside the PTQ tolerance")
    launches = {k: f_counts[k] + i_counts[k] for k in f_counts}

    # 5. Times.
    out = []
    for kname, replaces, source in (
            ("vita_layer", "src/repro/kernels/vita_layer.py:174",
             "src/repro_torch/kernels/vita_layer.py"),
            ("vita_layer_int8", "src/repro/kernels/vita_layer.py:430",
             "src/repro_torch/kernels/vita_layer.py"),
            ("vita_msa_int8", "src/repro/kernels/vita_msa.py:241",
             "src/repro_torch/kernels/vita_msa.py"),
            ("int8_matmul", "src/repro/kernels/int8_matmul.py:98",
             "src/repro_torch/kernels/int8_matmul.py")):
        r = records[kname]
        ms = device_ms(r["fn"])
        plain_ms = device_ms(r["plain"])
        lib_ms = device_ms(r["library"]) if r["library"] else None
        call_ms = time_ms(r["fn"])
        bound_ms, bound_by = r["bound"]
        out.append({"name": kname, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[kname],
                    "max_abs_err": r["err"], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms, "call_ms": call_ms})
        print(f"[time] {kname} on {name} ({card}): device {ms:.4f} ms "
              f"(per call with the host in the loop {call_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
    print("[time] device, plain and library times are device time summed "
          "by torch.profiler over 20 calls; the per-call time is CUDA "
          "events around 50 back-to-back calls")
    print("[time] library yardsticks: vita_layer = composition of cuBLAS "
          "matmuls + F.layer_norm + F.scaled_dot_product_attention + "
          "F.gelu (never called by the port); int8_matmul = torch._int_mm "
          "(int32 out, no rescale); none for the int8 layer and int8 MSA")
    for mode, server in (("float", f_server), ("int8", i_server)):
        server.submit_many(np.zeros((16,) + images.shape[1:], np.float32))
        server.run()                                    # warm
        server.submit_many(np.zeros((64,) + images.shape[1:], np.float32))
        stats = server.run()
        print(f"[time] served deit_t {mode} on {name} ({card}): bucket "
              f"{BUCKETS[-1]}, {stats['requests']} requests: "
              f"{stats['throughput_img_s']:.1f} img/s, p50 latency "
              f"{stats['latency_p50_ms']:.3f} ms (drain: queue included), "
              f"p50 service {stats['service_p50_ms']:.3f} ms")
    for mode, server in (("float", f_server), ("int8", i_server)):
        profile_drain(mode, server, images.shape[1:], f"{name} ({card})")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

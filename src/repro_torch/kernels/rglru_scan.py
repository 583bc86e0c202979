"""The RG-LRU linear recurrence on Hopper (counterpart of
`repro/kernels/rglru_scan.py::rglru_scan`).

One launch of ``csrc/rglru_scan.cu`` computes h_t = a_t h_{t-1} + b_t
along T of (B, T, W) with h carried in float32.  T up to one chunk (32
steps in fp32, 64 in bf16: the served prompts) is one thread per
(sequence, channel) walking T; longer T is cut into such chunks, one
block per (chunk, run of 128 channels of one sequence), the carry passed
between chunks by
decoupled look-back through a scratch buffer, as `scan_plan` lays it out.
Its flags live in a buffer kept per (device, stream), zeroed when it is
made and grown when a call needs more; each launch leaves them zero for
the next.  This function takes CUDA tensors only; the plain version is
`ref.linear_recurrence_ref`, chosen by `ops`.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch

from . import build
from .build import check, dtype_code, ptr, stream

# csrc/rglru_scan.cu: bytes of a chunk's row of a (and of b; 32 fp32
# steps, 64 bf16), channels a chunk block, threads a walk block.
SCAN_CHUNK_BYTES, SCAN_CHANNELS, WALK_THREADS = 128, 128, 64
# (device index, stream) -> the scan's flag buffer on that stream
_FLAGS: Dict[Tuple[int, int], torch.Tensor] = {}


class ScanPlan(NamedTuple):
    """One csrc/rglru_scan.cu launch, the 5 ints it takes: ``chunks``
    chunks of ``chunk`` steps, each walked by a block of ``channels``
    threads (one a channel) over ``runs`` runs of channels (every run of
    every sequence), and ``scratch`` bytes of device memory for the
    look-back's values (three floats per (chunk, sequence, channel));
    its flags are 1 + chunks x runs ints of the stream's flag buffer.
    The walk
    (T up to one chunk) is one chunk of T steps over ``runs`` blocks of
    64 channels and needs no scratch."""
    chunk: int
    channels: int
    chunks: int
    runs: int
    scratch: int


@functools.lru_cache(maxsize=None)
def scan_plan(b: int, t: int, w: int, dtype=torch.float32,
              walk: bool = False) -> ScanPlan:
    """The launch for (B, T, W) of ``dtype`` (float32 or bfloat16; h and
    the scratch are float32): a chunk is 128 bytes of each channel's a
    (and b), 32 steps in fp32 and 64 in bf16.  ``walk`` asks for the walk
    at any T (the design before the chunked scan, which `chip_smoke.py`
    times beside it)."""
    if min(b, t, w) < 1:
        raise ValueError(f"rglru_scan: no plan for B={b}, T={t}, W={w}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rglru_scan: no kernel for {dtype}")
    chunk = SCAN_CHUNK_BYTES // dtype.itemsize
    if t <= chunk or walk:
        return ScanPlan(t, WALK_THREADS, 1, -(-b * w // WALK_THREADS), 0)
    chunks, runs = -(-t // chunk), b * -(-w // SCAN_CHANNELS)
    return ScanPlan(chunk, SCAN_CHANNELS, chunks, runs, 3 * chunks * b * w * 4)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               walk: bool = False) -> torch.Tensor:
    """a, b (B, T, W) float32 or bfloat16 -> h (B, T, W) in a's dtype;
    ``walk`` forces the one-thread-per-channel walk (`scan_plan`)."""
    code = dtype_code("rglru_scan", a)
    check(a, "a", a.dtype)
    check(b, "b", a.dtype, tuple(a.shape))
    if a.dim() != 3:
        raise ValueError(f"rglru_scan: a must be (B, T, W), got "
                         f"{tuple(a.shape)}")
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    bsz, t, w = a.shape
    plan = scan_plan(bsz, t, w, a.dtype, walk)
    flags = vals = None
    if plan.scratch:
        flags = _flags(a.device, 1 + plan.chunks * plan.runs)
        vals = torch.empty(plan.scratch, device=a.device, dtype=torch.uint8)
    build.call("rglru_scan", "rt_rglru_scan", ptr(a), ptr(b), ptr(out), bsz,
               t, w, code, build.ints(plan), ptr(flags), ptr(vals), stream())
    return out


def _flags(device: torch.device, count: int) -> torch.Tensor:
    """The scan's flag buffer on ``device`` for the current stream, at
    least ``count`` int32: a new one is zeroed, and every launch leaves
    the count and flags it used zero again."""
    key = (device.index or 0, torch.cuda.current_stream(device).cuda_stream)
    buf = _FLAGS.get(key)
    if buf is None or buf.numel() < count:
        buf = _FLAGS[key] = torch.zeros(count, device=device,
                                        dtype=torch.int32)
    return buf

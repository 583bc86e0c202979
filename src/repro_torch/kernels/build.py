"""The kernels' launch layer: build, load and `call` the port's CUDA
kernels (plain C interface + ctypes), with what every launch shares: the
argument `check`, `ptr`, `dtype_code`, `ints`, `stream`, `query`, and the
card's shared memory (`SMEM_LIMIT`, `TWO_BLOCK_SMEM`), `sm_count` and
`blocks_per_sm`.  Kernel modules take these from here, never from one
another.

Each ``csrc/<name>.cu`` compiles with its own ``nvcc`` into
``build/repro_torch/<name>-<hash>.so`` at the checkout's root, where the
hash covers every file under ``csrc/`` and the compiler flags, so an edit
rebuilds and an unchanged tree reuses the library.  `build_all` starts
every compile at once and waits for all of them.  Nothing here runs at
import: the first launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from repro_torch import trace as _trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float

# Shared memory one block may use on an H100 (bytes); the most each of
# two resident blocks may use (an SM's 233,472 bytes, less the 1,024 the
# card keeps for each block).
SMEM_LIMIT = 232448
TWO_BLOCK_SMEM = 233472 // 2 - 1024

# Element-type codes of the kernels' C interfaces (csrc/common.cuh's
# ElemCode).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# What `call` counts while tracing is on (`repro_torch.trace`).
_LAUNCHES = _trace.counter("kernels.launches")
_LAUNCH_NS = _trace.counter("kernels.launch_ns")

# C signature of every entry point: (library, symbol) -> argtypes.
SIGNATURES = {
    ("layer_norm", "rt_layer_norm"): [P, P, P, P, I, I, F, P, I, I, P],
    ("gemm_i8", "rt_gemm_i8"): [P, L, P, L, I, L, P, L, I, I, I, I, P, P, P,
                                P, L, I, P, I, P, P],
    ("attention", "rt_attention"): [P, P, P, L, L, L, P, L, L, L, I, I, I,
                                    I, F, P, P, P, I, I, P, P],
    ("attention", "rt_attention_blocks_per_sm"): [I, I, P],
    ("vita_msa", "rt_vita_msa"): [P] * 7 + [I, P, L, L, L] + [I] * 5
    + [F, I, I, P, P],
    ("vita_msa", "rt_vita_msa_packed"): [P] * 7 + [I, P, L, L, L] + [I] * 5
    + [F, I, I, P, P],
    ("vita_msa", "rt_msa_project"): [P] * 8 + [I] * 7 + [P, P],
    ("mma_gemm", "rt_mma_gemm"): [P, L, P, L, P, L, I, I, I, P, P, L, I, I,
                                  I, I, P],
    ("gemm_wgmma", "rt_gemm_wgmma"): [P, L, P, P, P, L, I, I, I, P, P, L]
    + [I] * 7 + [P],
    ("fused_mlp", "rt_fused_mlp"): [P] * 8 + [I] * 8 + [P],
    ("fused_mlp", "rt_fused_mlp_splits"): [I] * 6 + [P],
    ("fused_mlp_rows", "rt_fused_mlp_rows"): [P] * 8 + [I] * 8 + [P],
    ("fused_mlp_rows", "rt_fused_mlp_rows_splits"): [I] * 6 + [P],
    ("flash_attention", "rt_flash_attention"): [P] * 4 + [I] * 6 + [F]
    + [I] * 4 + [P, P],
    ("decode_attention", "rt_decode_attention"): [P] * 6 + [I] * 5
    + [F, I, I, P],
    ("decode_attention", "rt_decode_attention_splits"): [I] * 4 + [P],
    ("rglru_scan", "rt_rglru_scan"): [P] * 3 + [I] * 4 + [P] * 4,
    ("vita_layer_group", "rt_vita_layer_group"): [P] * 25 + [I] * 8
    + [F, F, I, I, P, P],
    ("vita_layer_group", "rt_vita_layer_group_blocks_per_sm"): [I] * 4 + [P],
    ("vita_layer_group", "rt_vita_layer_group_int8"): [P] * 32 + [I] * 8
    + [F, F, I, P, P],
    ("vita_layer_group", "rt_vita_layer_group_int8_blocks_per_sm"): [I] * 2
    + [P],
}
LIBRARIES = tuple(sorted({lib for lib, _ in SIGNATURES}))

_loaded: Dict[str, ctypes.CDLL] = {}


def dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: float32 or bfloat16 inputs only, got "
                        f"{t.dtype}")
    return DTYPE_CODES[t.dtype]


def stream() -> int:
    """The current CUDA stream, as the C entries take it."""
    return torch.cuda.current_stream().cuda_stream


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def ints(values) -> ctypes.Array:
    """``values`` (a plan's ints) as the C int array the entries take."""
    return (ctypes.c_int * len(values))(*values)


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, where given)."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_all(names: Iterable[str] = LIBRARIES) -> Dict[str, str]:
    """Compile every missing library in parallel (one nvcc each).  Returns
    each compiler's output, after a first line "nvcc <seconds> s" (its
    wall time), with registers, shared memory and spills from ptxas, keyed
    by library; raises with the log if any compile fails."""
    missing = [n for n in names if not _target(n).exists()]
    if not missing:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def compile_one(name: str):
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc.returncode, tmp, (f"nvcc {time.perf_counter() - t0:.1f}"
                                      f" s\n{proc.stdout}")

    with ThreadPoolExecutor(len(missing)) as pool:
        results = dict(zip(missing, pool.map(compile_one, missing)))
    logs, failed = {}, []
    for name, (rc, tmp, log) in results.items():
        logs[name] = log
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first when missing), with the
    argument types of its entry points declared."""
    lib = _loaded.get(name)
    if lib is None:
        with _trace.span("vita.kernels.build", -1, LIBRARIES.index(name)):
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
        for (lib_name, sym), argtypes in SIGNATURES.items():
            if lib_name == name:
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def call(name: str, sym: str, *args) -> None:
    """Launch ``sym`` from library ``name`` and raise if CUDA reported an
    error for the launch.  While tracing is on, counts the launch
    (``kernels.launches``) and the host time inside the ``ctypes`` call,
    argument marshalling included (``kernels.launch_ns``)."""
    fn = getattr(library(name), sym)
    if _trace.ON:
        t = time.perf_counter_ns()
        err = fn(*args)
        ns = time.perf_counter_ns() - t
        _trace.count(_LAUNCHES)
        _trace.count(_LAUNCH_NS, ns)
    else:
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{sym} failed to launch: CUDA error {err}")


def query(name: str, sym: str, *args) -> int:
    """`call` ``sym``, an entry that writes one int through its last
    argument (a plan's splits, an occupancy), and return that int."""
    out = ctypes.c_int(0)
    call(name, sym, *args, ctypes.byref(out))
    return out.value


@functools.lru_cache(maxsize=None)
def blocks_per_sm(name: str, kernel: str, *args: int) -> int:
    """Blocks of ``kernel`` one SM holds (the card's occupancy calculator,
    through library ``name``'s ``rt_<kernel>_blocks_per_sm``)."""
    per_sm = query(name, f"rt_{kernel}_blocks_per_sm", *args)
    if per_sm < 1:
        raise RuntimeError(f"{kernel}: not one block fits on an SM")
    return per_sm

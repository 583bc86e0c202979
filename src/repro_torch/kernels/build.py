"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` compiles with its own ``nvcc`` into
``build/repro_torch/<name>-<hash>.so`` at the checkout's root, where the
hash covers every file under ``csrc/`` and the compiler flags, so an edit
rebuilds and an unchanged tree reuses the library.  `build_all` starts
every compile at once and waits for all of them.  Nothing here runs at
import: the first launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

from repro_torch import trace as _trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float

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
    error for the launch.  While tracing is on, counts the launch and the
    host time inside the ``ctypes`` call (`repro_torch.trace`)."""
    fn = getattr(library(name), sym)
    if _trace.ON:
        t = time.perf_counter_ns()
        err = fn(*args)
        _trace.launched(time.perf_counter_ns() - t)
    else:
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{sym} failed to launch: CUDA error {err}")

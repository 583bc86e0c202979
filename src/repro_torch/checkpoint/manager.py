"""Checkpointing with atomic commits and elastic restore (counterpart of
`repro/checkpoint/manager.py`).

  * every checkpoint is a directory ``step_<N>/`` holding one
    ``shard_<proc>.npz`` per process and a ``manifest.json`` listing each
    leaf's path key, shape and dtype;
  * writes go to ``step_<N>.tmp/`` and are renamed once the shard and
    the manifest are written: a save cut short never corrupts the
    latest good checkpoint;
  * ``restore(step, like)`` loads into the structure of ``like`` and
    puts each leaf on ``like``'s leaf's device in its dtype: a run saved
    on the card resumes on the CPU and back (the counterpart of the JAX
    package's `device_put` against a new sharding);
  * ``keep_n`` garbage-collects old steps, never the newest.

bfloat16 leaves (which numpy has no type for) are stored as their uint16
bits; the manifest keeps the dtype.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 process_index: Optional[int] = None):
        self.dir = directory
        self.keep_n = keep_n
        if process_index is None:
            process_index = dist.get_rank() if dist.is_initialized() else 0
        self.proc = process_index
        os.makedirs(directory, exist_ok=True)

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree: Any,
             extra_meta: Optional[Dict] = None) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = {}
        manifest = {"leaves": [], "step": step, "extra": extra_meta or {}}
        for path, leaf in tree_lib.leaves_with_path(tree):
            key = tree_lib.path_key(path)
            leaf = torch.as_tensor(leaf)
            arrays[key] = _to_numpy(leaf)
            manifest["leaves"].append(
                {"key": key, "shape": list(leaf.shape),
                 "dtype": str(leaf.dtype).replace("torch.", "")})
        np.savez(os.path.join(tmp, f"shard_{self.proc}.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final)   # atomic commit
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like``, each leaf in the dtype
        and on the device of ``like``'s leaf at its path."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            dtypes = {e["key"]: e["dtype"]
                      for e in json.load(f)["leaves"]}
        with np.load(os.path.join(d, f"shard_{self.proc}.npz")) as z:
            arrays = {k: z[k] for k in z.files}

        def load(path, leaf):
            key = tree_lib.path_key(path)
            t = _from_numpy(arrays[key], dtypes[key])
            leaf = torch.as_tensor(leaf)
            return t.to(device=leaf.device, dtype=leaf.dtype)

        return tree_lib.map_with_path(load, like)

    def restore_latest(self, like: Any) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, like
        return step, self.restore(step, like)

"""Process meshes for vision serving on torch.distributed (counterpart of
the vision part of `repro/launch/mesh.py`).

JAX serves a mesh from one controller: `shard_map` runs the per-shard body
on every device of the mesh.  The port runs SPMD, one process per mesh
position (a rank).  Rank 0 is the caller's process and owns the request
plane (queues, admission, stamps and stats).  It issues every mesh
operation as a command, a module-level function and its arguments, which
it broadcasts to the other ranks and then runs itself; the other ranks run
`World.serve_commands`, executing each command in order until the stop
command.  So every rank runs the same operations in the same order, and
the collectives inside a command (the model axis's all-reduces, the
gather of the logits) pair up.

A `World` is this process's view of the process group.  `start_world`
spawns ranks 1..n-1 (`torch.multiprocessing`'s spawn context: CUDA does
not survive ``fork``) and meets them through a file store in a fresh
temporary directory, so concurrent worlds never share a port; under
``torchrun`` the group it set up is used.  `launch_mesh(fn, data, model,
device)` runs ``fn`` on rank 0 of a world of data x model ranks and stops
the ranks it started afterwards; `world` is the same as a context.

The backend is chosen from the rank and card counts before any group is
built, and printed on a ``[mesh]`` line: NCCL where every rank has a card
of its own, gloo where ranks share a card (NCCL refuses two ranks on one
device) and on the CPU.  gloo stages CUDA tensors through the host, so a
mesh operation over gloo syncs the host.  Commands travel on a gloo group
of their own with a long timeout (an idle server waits there); the mesh's
groups carry the world's timeout, so a rank that dies or hangs inside a
command fails the others within it, and a failed command stops the ranks
this process started.

`make_vision_mesh(data, model, device)` builds a `VisionMesh` on the first
data x model ranks of the world (every rank builds the same groups, in the
same order).  A mesh pickles by key, so a command's mesh argument arrives
on each rank as that rank's own mesh.

`make_production_mesh` and `make_debug_mesh` are the dry run's meshes
(`launch.dryrun`): axis names and sizes only
(`distributed.sharding.AbstractMesh`), no ranks and no devices, since
the dry run is analytic.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import abstract_mesh

DEFAULT_TIMEOUT_S = 300.0
# How long an idle rank waits for its next command.
_IDLE = datetime.timedelta(days=7)
_JOIN_S = 30.0

_WORLD: Optional["World"] = None    # the process group is per process


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh's axes: one pod of 16 x 16 ``("data",
    "model")``, or two, 2 x 16 x 16 ``("pod", "data", "model")``."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def make_debug_mesh(*, multi_pod: bool = False, model: int = 2,
                    data: int = 2):
    """A tiny mesh with the production axis names."""
    if multi_pod:
        return abstract_mesh((2, data, model), ("pod", "data", "model"))
    return abstract_mesh((data, model), ("data", "model"))


def parse_mesh_shape(text) -> Tuple[int, int]:
    """``"4x2"`` -> ``(4, 2)``; a bare ``"8"`` -> ``(8, 1)`` (1-D mesh).

    The serve CLI's ``--mesh DxM`` grammar: D data-parallel by M
    model-parallel ranks.  Accepts an ``(int, int)`` tuple unchanged."""
    if isinstance(text, (tuple, list)):
        parts = [int(p) for p in text]
    else:
        try:
            parts = [int(p) for p in
                     str(text).lower().replace("×", "x").split("x")
                     if p != ""]
        except ValueError:
            parts = []
    if len(parts) == 1:
        parts.append(1)
    if len(parts) != 2 or parts[0] < 1 or parts[1] < 1:
        raise ValueError(f"mesh shape must be 'D' or 'DxM' with positive "
                         f"ints, got {text!r}")
    return tuple(parts)


def choose_backend(size: int, device=None) -> str:
    """NCCL when every one of ``size`` ranks gets a card of its own, gloo
    otherwise (ranks sharing a card, or the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.device_count() >= size:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank ``rank``'s device: the CPU, or card ``rank`` modulo the
    cards (with NCCL every rank has its own)."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", rank % torch.cuda.device_count())


class World:
    """This process's rank in the process group, the meshes built on it
    and the objects commands created on it (by id)."""

    def __init__(self, rank: int, size: int, backend: str,
                 timeout_s: float = DEFAULT_TIMEOUT_S, *,
                 procs: Tuple = (), tmpdir: Optional[str] = None,
                 owns_group: bool = False):
        self.rank, self.size, self.backend = rank, size, backend
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self.meshes: Dict[Tuple, "VisionMesh"] = {}
        self.objects: Dict[int, Any] = {}
        self.failed: Optional[str] = None
        self._next_id = 0
        self._released: List[int] = []
        self._procs = list(procs)
        self._tmpdir = tmpdir
        self._owns_group = owns_group
        self.cmd_group = (dist.new_group(backend="gloo", timeout=_IDLE)
                          if size > 1 else None)

    def new_id(self) -> int:
        self._next_id += 1
        return self._next_id

    def release(self, oid: int) -> None:
        """Drop object ``oid`` on every rank with the next command (safe
        to call from a finalizer: it only records the id)."""
        self._released.append(oid)

    def call(self, fn: Callable, *args):
        """Run ``fn(*args)`` on every rank (rank 0 issues) and return rank
        0's result.  A failure stops the ranks this process started and
        marks the world failed."""
        if self.rank != 0:
            raise RuntimeError("only rank 0 issues mesh commands")
        if self.failed:
            raise RuntimeError(f"the mesh failed earlier: {self.failed}")
        released, self._released = self._released, []
        try:
            if self.size > 1:
                dist.broadcast_object_list([(fn, args, released)], src=0,
                                           group=self.cmd_group)
            self._drop(released)
            return fn(*args)
        except BaseException as e:
            self.failed = f"{getattr(fn, '__name__', fn)}: {e!r}"
            self._stop_procs(kill=True)
            raise

    def _drop(self, released) -> None:
        for oid in released:
            self.objects.pop(oid, None)

    def serve_commands(self) -> None:
        """Ranks 1..n-1: run rank 0's commands in order until it stops."""
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self.cmd_group)
            fn, args, released = box[0]
            if fn is None:
                return
            self._drop(released)
            fn(*args)

    def _stop_procs(self, kill: bool) -> None:
        deadline = time.monotonic() + (0.0 if kill else _JOIN_S)
        for p in self._procs:
            p.join(max(deadline - time.monotonic(), 0.0))
            if p.is_alive():
                p.kill()
                p.join(_JOIN_S)
        codes = [p.exitcode for p in self._procs]
        self._procs = []
        if not kill and any(c != 0 for c in codes):
            self.failed = self.failed or f"ranks exited with {codes}"

    def close(self) -> None:
        """Stop the other ranks (rank 0), join those this process started,
        and tear the process group down.  Raises if a rank failed."""
        global _WORLD
        try:
            if self.rank == 0 and self.size > 1 and not self.failed:
                dist.broadcast_object_list([(None, (), [])], src=0,
                                           group=self.cmd_group)
            self._stop_procs(kill=bool(self.failed))
        finally:
            if self._owns_group and dist.is_initialized():
                dist.destroy_process_group()
            if self._tmpdir:
                shutil.rmtree(self._tmpdir, ignore_errors=True)
            if _WORLD is self:
                _WORLD = None
        if self.failed:
            raise RuntimeError(f"mesh ranks failed: {self.failed}")


def current_world() -> Optional[World]:
    """The world of this process: the one started here, or one around a
    process group set up elsewhere (torchrun; every rank gets here), or
    None."""
    global _WORLD
    if _WORLD is None and dist.is_initialized():
        _WORLD = World(dist.get_rank(), dist.get_world_size(),
                       dist.get_backend())
    return _WORLD


def _watch_parent(pid: int) -> None:
    """Exit when the process that spawned this rank is gone."""
    def run():
        while os.getppid() == pid:
            time.sleep(1.0)
        os._exit(1)
    threading.Thread(target=run, daemon=True).start()


def _worker_main(rank: int, size: int, init_method: str, backend: str,
                 device_type: str, timeout_s: float, parent: int) -> None:
    """Entry point of a spawned rank: join the group, serve commands."""
    global _WORLD
    _watch_parent(parent)
    if device_type == "cpu":
        torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    try:
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout_s))
        _WORLD = World(rank, size, backend, timeout_s, owns_group=True)
        _WORLD.serve_commands()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        os._exit(1)


def start_world(size: int, device=None, *,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> World:
    """Make this process rank 0 of a new world of ``size`` ranks, spawning
    the others; ``device`` (None = the card) decides the backend.  On the
    card every kernel library is built here first, so the ranks never
    race nvcc into the same files."""
    global _WORLD
    if current_world() is not None:
        raise RuntimeError("this process already belongs to a mesh world")
    dev_type = torch.device("cuda" if device is None else device).type
    if size <= 1:
        _WORLD = World(0, 1, "none", timeout_s)
        return _WORLD
    backend = choose_backend(size, device)
    cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    print(f"[mesh] backend={backend} ranks={size} cards={cards} "
          f"device={dev_type}", flush=True)
    if dev_type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    tmpdir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    init = "file://" + os.path.join(tmpdir, "store")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = []
    try:
        for r in range(1, size):
            p = ctx.Process(target=_worker_main, daemon=True,
                            args=(r, size, init, backend, dev_type,
                                  timeout_s, os.getpid()))
            p.start()
            procs.append(p)
        if backend == "nccl":
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=init, rank=0, world_size=size,
            timeout=datetime.timedelta(seconds=timeout_s))
        _WORLD = World(0, size, backend, timeout_s, procs=tuple(procs),
                       tmpdir=tmpdir, owns_group=True)
    except BaseException:
        for p in procs:
            p.kill()
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise
    return _WORLD


@contextlib.contextmanager
def world(size: int, device=None, *, timeout_s: float = DEFAULT_TIMEOUT_S):
    """A world of at least ``size`` ranks for the body: the existing one
    (a pool of ranks, or an enclosing world), or one set up here (from
    torchrun's environment, else by spawning ranks) and torn down after."""
    w = current_world()
    started = w is None
    if started and "WORLD_SIZE" in os.environ:
        backend = choose_backend(int(os.environ["WORLD_SIZE"]), device)
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s))
        w = current_world()
        w._owns_group = True
    elif started:
        w = start_world(size, device, timeout_s=timeout_s)
    try:
        if w.size < size:
            raise RuntimeError(f"a mesh of {size} ranks does not fit the "
                               f"world of {w.size}")
        yield w
    finally:
        if started:
            w.close()


def launch_mesh(fn: Callable, data: int = 1, model: int = 1, device=None,
                *args):
    """Run ``fn(*args)`` on rank 0 of a world of ``data * model`` ranks
    (started here unless one exists) and return its result; under
    torchrun the other ranks serve commands here and return None."""
    with world(data * model, device) as w:
        if w.rank != 0:
            w.serve_commands()
            return None
        return fn(*args)


class VisionMesh:
    """The ``(data, model)`` vision mesh on the first data x model ranks
    of a world: the axis sizes, this rank's coordinates (None outside the
    mesh), its device, the backend, and the process groups of the whole
    mesh, of this rank's data axis (the ranks at its model coordinate) and
    of its model axis (the ranks at its data coordinate).  ``model == 1``
    is the 1-D ``("data",)`` throughput mesh, as in the reference."""

    def __init__(self, w: World, data: int, model: int, device_type: str):
        self.world = w
        self.data, self.model, self.size = data, model, data * model
        self.key = (data, model, device_type)
        self.axis_names = ("data",) if model == 1 else ("data", "model")
        self.axis_sizes = (data,) if model == 1 else (data, model)
        self.backend = w.backend
        inside = w.rank < self.size
        self.rank = w.rank if inside else None
        self.coords = divmod(w.rank, model) if inside else None
        self.device = rank_device(w.rank, device_type)
        self.group = self.data_group = self.model_group = None
        if w.size > 1:
            kw = {"timeout": w.timeout}
            self.group = dist.new_group(list(range(self.size)), **kw)
            for m in range(model):
                g = dist.new_group([d * model + m for d in range(data)], **kw)
                if inside and self.coords[1] == m:
                    self.data_group = g
            for d in range(data):
                g = dist.new_group([d * model + m for m in range(model)],
                                   **kw)
                if inside and self.coords[0] == d:
                    self.model_group = g

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[0] if axis == "data" else self.coords[1]

    def call(self, fn: Callable, *args):
        """`World.call` on this mesh's world."""
        return self.world.call(fn, *args)

    def __reduce__(self):
        return (_mesh_by_key, (self.key,))

    def __repr__(self) -> str:
        return (f"VisionMesh({self.data}x{self.model}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def _mesh_by_key(key: Tuple) -> VisionMesh:
    return current_world().meshes[key]


def _build_mesh(data: int, model: int, device_type: str) -> VisionMesh:
    w = current_world()
    mesh = VisionMesh(w, data, model, device_type)
    w.meshes[mesh.key] = mesh
    return mesh


def make_vision_mesh(data: Optional[int] = None, model: int = 1,
                     device=None) -> VisionMesh:
    """The vision serving mesh on this world (module docstring); ``data``
    defaults to every rank divided by ``model``.  Raises as the reference
    does when the world is smaller than data x model."""
    w = current_world() or World(0, 1, "none")
    model = max(int(model), 1)
    if data is None:
        data = max(w.size // model, 1)
    data = int(data)
    need = data * model
    if data < 1 or need > w.size:
        raise RuntimeError(
            f"vision mesh ({data}, {model}) needs {need} ranks, found "
            f"{w.size}; start them with launch_mesh() / world() (or "
            f"torchrun --nproc-per-node {need})")
    dev_type = torch.device("cuda" if device is None else device).type
    mesh = w.meshes.get((data, model, dev_type))
    if mesh is None:
        if w.size == 1:
            mesh = VisionMesh(w, data, model, dev_type)
            w.meshes[mesh.key] = mesh
        else:
            mesh = w.call(_build_mesh, data, model, dev_type)
    return mesh


# ---------------------------------------------------------------------------
# Objects that live on every rank of a mesh
# ---------------------------------------------------------------------------


def create(mesh: VisionMesh, factory: Callable, *args) -> Tuple[int, Any]:
    """``factory(*args)`` on every rank of ``mesh``, kept under one id on
    each: (id, rank 0's object).  `World.release` drops it."""
    return mesh.call(_create, mesh, factory, args)


def _create(mesh: VisionMesh, factory: Callable, args) -> Tuple[int, Any]:
    oid = mesh.world.new_id()
    obj = factory(*args) if mesh.rank is not None else None
    mesh.world.objects[oid] = obj
    return oid, obj


def invoke(mesh: VisionMesh, oid: int, method: str, *args):
    """``obj.method(*args)`` on every rank of ``mesh`` for the object
    `create` made under ``oid``; rank 0's result."""
    return mesh.call(_invoke, mesh, oid, method, args)


def _invoke(mesh: VisionMesh, oid: int, method: str, args):
    obj = mesh.world.objects.get(oid)
    return None if obj is None else getattr(obj, method)(*args)


def per_rank(mesh: VisionMesh, fn: Callable, *args) -> List[Any]:
    """``fn(*args)`` on every rank of ``mesh``; the list of the ranks'
    results, in rank order, on rank 0."""
    return mesh.call(_per_rank, mesh, fn, args)


def _per_rank(mesh: VisionMesh, fn: Callable, args) -> List[Any]:
    res = fn(*args) if mesh.rank is not None else None
    w = mesh.world
    if w.size == 1:
        return [res]
    out: List[Any] = [None] * w.size
    dist.all_gather_object(out, res, group=w.cmd_group)
    return out[:mesh.size]

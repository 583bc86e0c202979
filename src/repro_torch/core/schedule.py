"""ViTA control program (counterpart of `repro/core/schedule.py`).

`compile_schedule` turns a `VisionModelSpec` into the phase list the
executor replays; `fuse_schedule` collapses each msa + mlp pair of one
encoder block into a fused ``layer`` phase and, with ``group_size > 1``,
runs of compatible fused layers into ``layer_group`` phases;
`run_schedule` replays a schedule over the port's kernels.  Three layouts:

  * columnar (ViT / DeiT): ``embed`` (+ positional embedding), msa/mlp per
    block at ``layers[i]`` / site ``l{i}``, ``head``;
  * hierarchical (Swin): ``embed`` (+ LayerNorm), windowed msa/mlp per
    block at ``stages[s].blocks[b]`` / site ``s{s}.b{b}``, shifted by half
    a window on odd blocks where a stage has more than one window, a
    ``merge`` phase after every stage but the last, ``head``;
  * dual-stream (TNT): the columnar layout whose ``embed`` also seeds the
    inner (pixel) stream (`pixel_partition`, ``pixel_embed``, LN, then
    ``patch_embed`` into the outer stream), and per block ``inner_msa`` /
    ``inner_mlp`` at ``layers[i].inner`` / site ``l{i}.inner`` on the
    inner stream, a ``fold`` at ``layers[i]`` / site ``l{i}.fold`` (LN of
    each patch's flattened pixel tokens, linear, residual into the outer
    stream), then msa/mlp at ``layers[i].outer`` / site ``l{i}``.

Windowed attention runs the same kernels as global attention, with the
windows folded into the batch axis and the relative-position bias plus
the shifted-window mask passed along; TNT's inner blocks run them too,
their batch axis carrying images x patches.  The executor's state is the
(outer stream, inner stream) pair; the inner stream is None outside TNT.
Float msa/mlp phases run the per-head MSA and fused MLP kernels; fused
float layers the float layer kernel.  int8 layers run the fused int8
kernel at the frozen calibration scales and fall back to the unfused
int8 MSA and MLP while the calibrator is still recording, so it sees
every intermediate activation.  A ``layer_group`` phase runs its L
members as one layer-group kernel launch (float or int8; int8
calibration falls back to each member's layer phase), with the window
fold done once for the whole group.  The fusion pass fuses
``inner_msa`` + ``inner_mlp`` into ``inner_layer`` (the same float or
int8 layer kernel) and would group runs of ``inner_layer`` into
``inner_layer_group``; compiled TNT schedules never group, since a
``fold`` sits between every two blocks.
`FusionPolicy` decides per served batch whether the fused schedule runs,
and at which group size.  `profile_schedule` replays a schedule one phase
at a time and times each phase (the live HUE profile, `core.hue`).

Where the stacking is held: the group kernel reads (L, ...) operands.
The reference stacks the member subtrees inside its jitted forward; here
that would be a copy of every group weight per micro-batch, so
`_group_operands` stacks them once per (param tree, group) and keeps them
in `_STACKED`, keyed weakly by the lead member's ``wq`` tensor (a new or
freed param tree drops its entries; param trees are not mutated in
place).  The (L, 4) int8 activation scales come from the frozen
calibrator's own cache, `Calibrator.stacked`.

dtypes flow as in the reference: LayerNorm returns its input's dtype
(`ops.layer_norm`); the float embed / merge / head products take
PyTorch's promotion of their two operands (float32 x bfloat16 gives
float32, as jnp's does, where torch.matmul would raise), so a bf16 model
served on float32 images keeps a float32 residual stream and float32
logits, and `forward` on bf16 patches runs bf16 throughout; the kernels
take each (activation, weight) dtype pair of `ref.PORTED_MODES`.

Sharding (the reference's `shard_map` bodies, on torch.distributed): on a
model-axis mesh every rank replays the schedule on its local shards (its
heads with their concat rows, its MLP columns with their down rows;
`distributed.sharding`) and a `ShardCtx` says where the two row-parallel
products of each encoder block are all-reduced over the model axis.
Fused layers run the layer kernels' chains split at those reductions
(`kernels.vita_layer`); a layer group whose members reduce runs its L
layers through that split per-layer chain, since the group kernels
cannot all-reduce mid-kernel (the reference's group oracle is layer by
layer too); on a data-only mesh groups keep their group kernels.  The
embed, fold, merge and head weights replicate and compute full width on
every rank.  `run_schedule_sharded` is the entry point: every rank of the
mesh replays its rows (`build_sharded_fn`) and the logits are gathered.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import trace
from repro_torch.core.perfmodel import VisionModelSpec
from repro_torch.core.quant import INT8_MAX, QTensor, stack_qtensors
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gelu, psum
from repro_torch.models.layers import to_device

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Phase:
    """One control-program step.  ``path`` addresses the param subtree the
    phase reads; ``site`` prefixes its activation-calibration entries."""

    kind: str                      # embed | msa | mlp | layer
                                   # | layer_group | merge | head
                                   # | inner_msa | inner_mlp | inner_layer
                                   # | inner_layer_group | fold (TNT)
    path: Tuple[Any, ...]
    site: str
    grid: Tuple[int, int]          # (h, w) token grid at phase input
                                   # (inner phases: the pixel sub-grid)
    heads: int = 0                 # surviving heads of this layer; the
                                   # grouping pass compares it, so ragged
                                   # pruning splits groups
    window: int = 0                # 0 -> global MSA
    shift: int = 0                 # shifted-window offset (odd Swin blocks)
    pos_embed: bool = False        # embed: add the positional embedding
    norm: bool = False             # embed: LayerNorm after the projection
    inner_tokens: int = 0          # embed: pixel tokens per patch (TNT; 0:
                                   # a single-stream frontend)
    members: Tuple["Phase", ...] = ()  # layer_group: the grouped layer
                                   # phases in execution order (else empty)


@dataclasses.dataclass(frozen=True)
class Schedule:
    name: str
    image: int
    patch: int
    n_classes: int
    phases: Tuple[Phase, ...]

    def counts(self) -> dict:
        out: dict = {}
        for p in self.phases:
            out[p.kind] = out.get(p.kind, 0) + 1
        return out


def compile_schedule(spec: VisionModelSpec, *, n_classes: int,
                     hierarchical: Optional[bool] = None) -> Schedule:
    """Compile a model spec into the phase list the executor replays.

    ``hierarchical`` selects the Swin layout (windowed MSA, ``stages/
    blocks`` paths, patch merging); by default it is inferred from the spec
    (several stages, windowed stages or patch merging).  A first stage
    with ``inner_tokens`` compiles TNT's dual-stream layout."""
    if hierarchical is None:
        hierarchical = (len(spec.stages) > 1
                        or any(s.n_windows > 1 for s in spec.stages)
                        or any(s.patch_merging for s in spec.stages))
    img_h, img_w, _ = spec.image
    if img_h != img_w:
        raise ValueError("the control program assumes square images")
    side = img_h // spec.patch
    inner_embed = spec.stages[0].inner_tokens if spec.stages else 0
    if inner_embed and hierarchical:
        raise ValueError("TNT inner blocks assume the columnar "
                         "(single-stage) layout")
    phases = [Phase(kind="embed", path=(), site="patch_embed",
                    grid=(side, side), pos_embed=not hierarchical,
                    norm=hierarchical or bool(inner_embed),
                    inner_tokens=inner_embed)]
    flat_layer = 0
    for s_i, st in enumerate(spec.stages):
        if int(math.isqrt(st.tokens * st.n_windows)) != side:
            raise ValueError(f"stage {s_i}: token grid "
                             f"{st.tokens * st.n_windows} != {side}x{side}")
        window = int(math.isqrt(st.tokens)) if hierarchical else 0
        if window and side % window:
            raise ValueError(f"stage {s_i}: side {side} not divisible by "
                             f"window {window}")
        if st.inner_tokens:
            # The embed phase seeds the inner stream once, so inner blocks
            # can only live in the first (columnar) stage.
            if s_i != 0 or hierarchical:
                raise ValueError(f"stage {s_i}: inner blocks require the "
                                 f"columnar single-stage layout (TNT)")
            mi = int(math.isqrt(st.inner_tokens))
            if mi * mi != st.inner_tokens:
                raise ValueError(f"stage {s_i}: inner tokens "
                                 f"{st.inner_tokens} not square")
        for b_i in range(st.layers):
            if hierarchical:
                path, site = ("stages", s_i, "blocks", b_i), f"s{s_i}.b{b_i}"
            else:
                path, site = ("layers", flat_layer), f"l{flat_layer}"
                flat_layer += 1
            if st.inner_tokens:
                # TNT: the pixel-level block runs first on the inner stream
                # (batch axis images x patches), then folds back into the
                # outer token.
                inner = path + ("inner",)
                phases.append(Phase(kind="inner_msa", path=inner,
                                    site=f"{site}.inner", grid=(mi, mi),
                                    heads=st.inner_heads))
                phases.append(Phase(kind="inner_mlp", path=inner,
                                    site=f"{site}.inner", grid=(mi, mi)))
                phases.append(Phase(kind="fold", path=path,
                                    site=f"{site}.fold", grid=(side, side)))
            block = path + ("outer",) if st.inner_tokens else path
            # Swin alternates plain and shifted windows; with a single
            # window the shift is a no-op and is elided.
            shift = (window // 2 if window and b_i % 2 == 1
                     and st.n_windows > 1 else 0)
            phases.append(Phase(kind="msa", path=block, site=site,
                                grid=(side, side),
                                heads=st.layer_heads(b_i), window=window,
                                shift=shift))
            phases.append(Phase(kind="mlp", path=block, site=site,
                                grid=(side, side)))
        if st.patch_merging:
            phases.append(Phase(kind="merge", path=("stages", s_i),
                                site=f"s{s_i}.merge", grid=(side, side)))
            side //= 2
    phases.append(Phase(kind="head", path=(), site="head", grid=(side, side)))
    return Schedule(name=spec.name, image=img_h, patch=spec.patch,
                    n_classes=n_classes, phases=tuple(phases))


FUSABLE_PAIRS = {("msa", "mlp"): "layer",
                 ("inner_msa", "inner_mlp"): "inner_layer"}

# Fused kinds the grouping pass may collapse into layer-group phases.
# Compiled TNT schedules interleave a fold between every two inner layers,
# so ``inner_layer_group`` forms only in hand-edited ones.
GROUPABLE_KINDS = {"layer": "layer_group",
                   "inner_layer": "inner_layer_group"}


def _groupable(p: Phase, q: Phase) -> bool:
    """True iff adjacent fused layer ``q`` may join ``p``'s group: same
    kind, identical geometry (the group kernel does one window fold and
    takes one stacked operand layout, so surviving heads must match too)
    and the same stage (paths differing only in the trailing block
    index)."""
    return (q.kind == p.kind
            and q.grid == p.grid and q.window == p.window
            and q.shift == p.shift and q.heads == p.heads
            and len(q.path) == len(p.path)
            and q.path[:-1] == p.path[:-1])


def _group_layers(phases, group_size: int):
    """Collapse maximal runs of compatible fused layers into group phases
    of at most ``group_size`` members (greedy chunks; a leftover chunk of
    one stays a plain layer, so every layer is covered exactly once and
    regrouping is a no-op)."""
    out = []
    i = 0
    while i < len(phases):
        p = phases[i]
        gkind = GROUPABLE_KINDS.get(p.kind)
        if gkind is None:
            out.append(p)
            i += 1
            continue
        run = [p]
        while (i + len(run) < len(phases) and len(run) < group_size
               and _groupable(p, phases[i + len(run)])):
            run.append(phases[i + len(run)])
        if len(run) == 1:
            out.append(p)
        else:
            out.append(dataclasses.replace(
                p, kind=gkind, members=tuple(run),
                site=f"{run[0].site}..{run[-1].site}"))
        i += len(run)
    return out


def fuse_schedule(sched: Schedule, *, group_size: int = 1) -> Schedule:
    """Collapse adjacent msa -> mlp (and inner_msa -> inner_mlp) phases
    of one block (same path, site and grid) into fused ``layer`` (and
    ``inner_layer``) phases, which keep the msa half's window, shift and
    heads.  With ``group_size > 1`` a second sweep collapses runs of
    compatible fused layers (same kind, stage and geometry, `_groupable`)
    into ``layer_group`` (``inner_layer_group``) phases of at most
    ``group_size`` members.  ``group_size <= 1`` gives the per-layer fused schedule; the
    pass is idempotent at any size."""
    fused = []
    i = 0
    phases = sched.phases
    while i < len(phases):
        p = phases[i]
        nxt = phases[i + 1] if i + 1 < len(phases) else None
        kind = FUSABLE_PAIRS.get((p.kind, nxt.kind)) if nxt else None
        if kind and nxt.path == p.path and nxt.site == p.site \
                and nxt.grid == p.grid:
            fused.append(dataclasses.replace(p, kind=kind))
            i += 2
        else:
            fused.append(p)
            i += 1
    if group_size > 1:
        fused = _group_layers(fused, group_size)
    return dataclasses.replace(sched, phases=tuple(fused))


# ---------------------------------------------------------------------------
# Window geometry (shared by the executor and the Swin reference path)
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, win*win, C), contiguous; window id =
    index % nW."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)


def window_reverse(xw: torch.Tensor, win: int, h: int, w: int
                   ) -> torch.Tensor:
    """Inverse of `window_partition`."""
    b = xw.shape[0] // ((h // win) * (w // win))
    x = xw.reshape(b, h // win, w // win, win, win, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def pixel_partition(patches: torch.Tensor, m: int) -> torch.Tensor:
    """(B, N, P*P*3) patch pixel vectors -> (B*N, m, P*P*3/m) sub-patches,
    contiguous: TNT's counterpart of `window_partition`.  Each patch's
    P x P pixel block splits into an ms x ms grid (ms = sqrt(m)) of
    (P/ms)-pixel-square sub-patches and the patches fold into the batch
    axis: inner row r holds patch r % N of image r // N, inner token t the
    sub-patch at (t // ms, t % ms), in the (row, col, channel) flattening
    of `models.vit.extract_patches`."""
    b, n, pd = patches.shape
    ms = int(math.isqrt(m))
    if ms * ms != m:
        raise ValueError(f"inner token count {m} must be a square")
    p = int(math.isqrt(pd // 3))
    if p * p * 3 != pd:
        raise ValueError(f"patch dim {pd} is not P*P*3")
    if p % ms:
        raise ValueError(f"patch side {p} not divisible by sub-grid {ms}")
    ip = p // ms
    x = patches.reshape(b * n, ms, ip, ms, ip, 3)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b * n, m, ip * ip * 3)


@functools.lru_cache(maxsize=None)
def rel_pos_index(win: int) -> np.ndarray:
    """(n, n) gather indices into the (2*win-1)^2 relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(win), np.arange(win),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]          # (2, n, n)
    rel = rel.transpose(1, 2, 0) + (win - 1)
    return (rel[..., 0] * (2 * win - 1) + rel[..., 1]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(grid_h: int, grid_w: int, win: int,
                        shift: int) -> np.ndarray:
    """(nW, n, n) additive mask (0 / NEG_INF) for shifted-window attention.

    After a (-shift, -shift) roll, tokens from opposite image edges share a
    window; the standard Swin region labelling keeps attention within the
    9 contiguous source regions.  shift == 0 yields an all-zero mask (the
    kernels' windowed mode always takes a mask)."""
    n_w = (grid_h // win) * (grid_w // win)
    n = win * win
    if shift == 0:
        return np.zeros((n_w, n, n), np.float32)
    ids = np.zeros((grid_h, grid_w), np.int32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            ids[hs, ws] = cnt
            cnt += 1
    idw = ids.reshape(grid_h // win, win, grid_w // win, win)
    idw = idw.transpose(0, 2, 1, 3).reshape(n_w, n)
    same = idw[:, :, None] == idw[:, None, :]
    return np.where(same, 0.0, NEG_INF).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mask_on(grid_h: int, grid_w: int, win: int, shift: int,
             device: torch.device) -> torch.Tensor:
    """`shifted_window_mask` as a tensor on ``device``, made once."""
    return torch.from_numpy(shifted_window_mask(grid_h, grid_w, win,
                                                shift)).to(device)


@functools.lru_cache(maxsize=None)
def _rel_index_on(win: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rel_pos_index(win).astype(np.int64)).to(device)


def _window_terms(ph: Phase, bp: Any, device: torch.device):
    """The (H, n, n) relative-position bias gathered from the block's
    table, in float32 (as the kernels take it), and the (nW, n, n)
    shifted-window mask of a windowed phase."""
    gh, gw = ph.grid
    idx = _rel_index_on(ph.window, device)
    bias = bp["rel_bias"].float()[idx].permute(2, 0, 1).contiguous()
    return bias, _mask_on(gh, gw, ph.window, ph.shift, device)


def _fold(ph: Phase, x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B * nW, n, C): roll by -shift, then partition."""
    b, _, c = x.shape
    gh, gw = ph.grid
    xs = x.reshape(b, gh, gw, c)
    if ph.shift:
        xs = torch.roll(xs, (-ph.shift, -ph.shift), dims=(1, 2))
    return window_partition(xs, ph.window)


def _unfold(ph: Phase, yw: torch.Tensor, b: int) -> torch.Tensor:
    """Inverse of `_fold`: (B * nW, n, C) -> (B, T, C)."""
    gh, gw = ph.grid
    y = window_reverse(yw, ph.window, gh, gw)
    if ph.shift:
        y = torch.roll(y, (ph.shift, ph.shift), dims=(1, 2))
    return y.reshape(b, gh * gw, y.shape[-1])


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def _subtree(params: Any, path: Tuple[Any, ...]) -> Any:
    node = params
    for k in path:
        node = node[k]
    return node


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Model-axis collective context for a sharded replay.

    Every weight of the replay is the rank's LOCAL shard, and the two
    row-parallel contractions of each encoder block (the MSA concat
    projection and the MLP down projection) give partial products that
    are all-reduced over the model axis before their residual re-entries.

    ``specs`` is `distributed.sharding.vision_param_specs` of the WHOLE
    param tree: `reduce_axis` reads the block's weight spec back, so the
    placement rule and the collective cannot disagree, and a block whose
    heads replicated (H not divisible) fires no all-reduce.  ``group`` is
    the rank's model-axis process group.  None in place of a ShardCtx is
    the single-device and data-parallel replay: no collectives."""

    group: Any
    specs: Any

    def reduce_axis(self, path: Tuple[Any, ...], key: str):
        """The process group to all-reduce over after contracting with
        weight ``key`` of the block at ``path``, or None (replicated)."""
        node = _subtree(self.specs, path)[key]
        if isinstance(node, QTensor):
            node = node.values
        return self.group if node and node[0] == "model" else None

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return psum(x, self.group)


def _quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX
                       ).to(torch.int8)


def _matmul(x: torch.Tensor, w: Any, obs, site: str) -> torch.Tensor:
    """matmul with optional int8 quantization (w: tensor or QTensor).  The
    int8 product goes through the port's `int8_matmul` with the
    x_scale * w_scale rescale in its epilogue."""
    if isinstance(w, QTensor):
        scale = obs.observe(site, x)
        xq = _quant(x, scale).reshape(-1, x.shape[-1])
        y = ops.int8_matmul(xq, w.values, scale, w.scale.reshape(-1))
        return y.reshape(*x.shape[:-1], w.values.shape[-1])
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _head_scale(wq: QTensor) -> torch.Tensor:
    """Per-(head, out-channel) scale (H, 1, Dh) -> the (H, Dh) kernel form."""
    h, _, dh = wq.values.shape
    return wq.scale.reshape(h, dh)


def _per_head_msa(bp: Any, z: torch.Tensor, obs, site: str,
                  quantized: bool, bias, mask) -> torch.Tensor:
    """Per-head MSA over (B', N, C) -> (B', N, H*Dh), heads merged; B' is
    images, or images * windows in windowed mode."""
    b, n, _ = z.shape
    if quantized:
        scale = obs.observe(f"{site}.qkv_in", z)
        sa = ops.vita_msa_int8(
            _quant(z, scale), bp["wq"].values, bp["wk"].values,
            bp["wv"].values, scale, _head_scale(bp["wq"]),
            _head_scale(bp["wk"]), _head_scale(bp["wv"]), bias, mask)
    else:
        sa = ops.vita_msa_batched(z, bp["wq"], bp["wk"], bp["wv"], bias,
                                  mask)
    h, dh = sa.shape[1], sa.shape[3]
    return sa.permute(0, 2, 1, 3).reshape(b, n, h * dh).to(z.dtype)


def _msa_phase(ph: Phase, bp: Any, x: torch.Tensor, obs,
               quantized: bool, shard: Optional[ShardCtx] = None
               ) -> torch.Tensor:
    """Unfused MSA phase: LN -> per-head MSA (windowed: folded into the
    batch axis) -> concat projection -> residual.  Head-sharded: ``sa``
    holds the local heads' concat columns and w_msa their rows, so the
    partials are summed over the model axis before the residual."""
    z = ops.layer_norm(x, bp["ln1_w"], bp["ln1_b"])
    if ph.window:
        bias, mask = _window_terms(ph, bp, x.device)
        sa = _per_head_msa(bp, _fold(ph, z), obs, ph.site, quantized, bias,
                           mask)
        sa = _unfold(ph, sa, x.shape[0])
    else:
        sa = _per_head_msa(bp, z, obs, ph.site, quantized, None, None)
    proj = _matmul(sa, bp["w_msa"], obs, f"{ph.site}.w_msa")
    if shard is not None and shard.reduce_axis(ph.path, "w_msa"):
        proj = shard.psum(proj)
    return x + proj


def _mlp_phase(ph: Phase, bp: Any, x: torch.Tensor, obs,
               quantized: bool, shard: Optional[ShardCtx] = None
               ) -> torch.Tensor:
    """Unfused MLP phase: LN -> up -> GELU -> down -> residual; float
    through the fused MLP kernel, int8 through two int8 matmuls.
    Column-sharded: w_up / b_up hold the local hidden columns and w_down
    the matching rows, so the down partial is summed over the model axis
    and b_down added once, after the sum."""
    h = ops.layer_norm(x, bp["ln2_w"], bp["ln2_b"])
    reduce = shard is not None and shard.reduce_axis(ph.path, "w_down")
    if quantized:
        hid = gelu(_matmul(h, bp["w_up"], obs, f"{ph.site}.w_up")
                   + bp["b_up"])
        y = _matmul(hid, bp["w_down"], obs, f"{ph.site}.w_down")
        if reduce:
            y = shard.psum(y)
        y = y + bp["b_down"]
    elif reduce:
        y = shard.psum(ops.mlp(h, bp["w_up"], bp["w_down"], bp["b_up"],
                               None, activation="gelu")) + bp["b_down"]
    else:
        y = ops.mlp(h, bp["w_up"], bp["w_down"], bp["b_up"], bp["b_down"],
                    activation="gelu")
    return x + y


def _fused_layer_call(ph: Phase, bp: Any, x: torch.Tensor, obs,
                      quantized: bool, bias, mask,
                      shard: Optional[ShardCtx] = None) -> torch.Tensor:
    """One fused encoder layer over (B', N, C); B' is images, or images *
    windows in windowed mode (the fold happens in `_layer_phase`)."""
    axes = {"msa_axis": shard.reduce_axis(ph.path, "w_msa") if shard
            else None,
            "mlp_axis": shard.reduce_axis(ph.path, "w_down") if shard
            else None}
    if quantized:
        # The four frozen per-site scales the calibration pass recorded
        # feed the kernel's requant chain.
        act_scales = torch.stack([
            obs.observe(f"{ph.site}.qkv_in", x),
            obs.observe(f"{ph.site}.w_msa", x),
            obs.observe(f"{ph.site}.w_up", x),
            obs.observe(f"{ph.site}.w_down", x)]).reshape(4)
        return ops.vita_layer_int8(
            x, bp["wq"].values, bp["wk"].values, bp["wv"].values,
            bp["w_msa"].values, bp["w_up"].values, bp["w_down"].values,
            act_scales, _head_scale(bp["wq"]), _head_scale(bp["wk"]),
            _head_scale(bp["wv"]), bp["w_msa"].scale, bp["w_up"].scale,
            bp["w_down"].scale, bp["ln1_w"], bp["ln1_b"], bp["ln2_w"],
            bp["ln2_b"], bp["b_up"], bp["b_down"], bias, mask,
            **axes).to(x.dtype)
    return ops.vita_layer_fused(
        x, bp["wq"], bp["wk"], bp["wv"], bp["w_msa"], bp["ln1_w"],
        bp["ln1_b"], bp["ln2_w"], bp["ln2_b"], bp["w_up"], bp["b_up"],
        bp["w_down"], bp["b_down"], bias, mask, **axes)


def _layer_phase(ph: Phase, bp: Any, x: torch.Tensor, obs,
                 quantized: bool, shard: Optional[ShardCtx] = None
                 ) -> torch.Tensor:
    """Fused encoder layer.  int8 calibration (observer not yet frozen)
    falls back to the unfused executors so the observer sees every
    intermediate activation at the sites the fused kernel later reads.
    Windowed: every step but attention is per token, so the whole layer
    runs on the window fold."""
    if quantized and (obs is None or obs.frozen is None):
        x = _msa_phase(ph, bp, x, obs, quantized, shard)
        return _mlp_phase(ph, bp, x, obs, quantized, shard)
    if not ph.window:
        return _fused_layer_call(ph, bp, x, obs, quantized, None, None,
                                 shard)
    bias, mask = _window_terms(ph, bp, x.device)
    yw = _fused_layer_call(ph, bp, _fold(ph, x), obs, quantized, bias, mask,
                           shard)
    return _unfold(ph, yw, x.shape[0])


_STACKED: WeakIdKeyDictionary = WeakIdKeyDictionary()


def _stack_block_params(bps) -> Dict[str, Any]:
    """Per-layer block subtrees stacked into leading-axis (L, ...)
    operands; `QTensor` leaves stack values and scales separately
    (`quant.stack_qtensors`), so each member keeps its own scales."""
    out: Dict[str, Any] = {}
    for k in bps[0]:
        vals = [bp[k] for bp in bps]
        out[k] = (stack_qtensors(vals) if isinstance(vals[0], QTensor)
                  else torch.stack(vals))
    return out


def _group_operands(ph: Phase, params: Any) -> Dict[str, Any]:
    """The group's stacked operands, and in windowed mode its (L, H, n, n)
    relative-position bias as ``"bias"``, made on first use and then read
    from `_STACKED` (see the module docstring)."""
    lead = _subtree(params, ph.members[0].path)["wq"]
    key = lead.values if isinstance(lead, QTensor) else lead
    per_tree = _STACKED.setdefault(key, {})
    paths = tuple(m.path for m in ph.members)
    sp = per_tree.get(paths)
    if sp is None:
        sp = _stack_block_params([_subtree(params, p) for p in paths])
        if ph.window:
            idx = _rel_index_on(ph.window, sp["rel_bias"].device)
            sp["bias"] = sp["rel_bias"].float()[:, idx].permute(
                0, 3, 1, 2).contiguous()
        per_tree[paths] = sp
    return sp


def _group_head_scale(wq: QTensor) -> torch.Tensor:
    """Stacked per-(layer, head, out-channel) scale (L, H, 1, Dh) -> the
    (L, H, Dh) group-kernel form."""
    n_l, h, _, dh = wq.values.shape
    return wq.scale.reshape(n_l, h, dh)


def _grouped_layer_call(ph: Phase, sp: Dict[str, Any], x: torch.Tensor,
                        obs, quantized: bool, bias, mask) -> torch.Tensor:
    """One layer-group kernel call over (B', N, C); B' is images, or
    images * windows in windowed mode (the fold happens in the caller)."""
    if quantized:
        # (L, 4): each member's four frozen calibration scales.
        act_scales = obs.stacked(tuple(
            f"{m.site}.{s}" for m in ph.members
            for s in ("qkv_in", "w_msa", "w_up", "w_down"))).reshape(-1, 4)
        return ops.vita_layer_group_int8(
            x, sp["wq"].values, sp["wk"].values, sp["wv"].values,
            sp["w_msa"].values, sp["w_up"].values, sp["w_down"].values,
            act_scales, _group_head_scale(sp["wq"]),
            _group_head_scale(sp["wk"]), _group_head_scale(sp["wv"]),
            sp["w_msa"].scale, sp["w_up"].scale, sp["w_down"].scale,
            sp["ln1_w"], sp["ln1_b"], sp["ln2_w"], sp["ln2_b"], sp["b_up"],
            sp["b_down"], bias, mask).to(x.dtype)
    return ops.vita_layer_group(
        x, sp["wq"], sp["wk"], sp["wv"], sp["w_msa"], sp["ln1_w"],
        sp["ln1_b"], sp["ln2_w"], sp["ln2_b"], sp["w_up"], sp["b_up"],
        sp["w_down"], sp["b_down"], bias, mask)


def _layer_group_phase(ph: Phase, params: Any, x: torch.Tensor, obs,
                       quantized: bool, shard: Optional[ShardCtx] = None
                       ) -> torch.Tensor:
    """L encoder blocks as one layer-group kernel call.  int8 calibration
    (observer not yet frozen) falls back to each member's `_layer_phase`,
    which itself runs unfused, so the observer sees every member's sites.
    Under a reducing model axis the members run one by one through the
    per-layer chain split at its all-reduces (the group kernels cannot
    all-reduce mid-kernel); members share their specs (same shapes), so
    the lead member decides.  Members share window and shift, so the
    window fold happens once for the whole group."""
    lead = ph.members[0].path
    split = shard is not None and (shard.reduce_axis(lead, "w_msa")
                                   or shard.reduce_axis(lead, "w_down"))
    if split or (quantized and (obs is None or obs.frozen is None)):
        for m in ph.members:
            x = _layer_phase(m, _subtree(params, m.path), x, obs, quantized,
                             shard)
        return x
    sp = _group_operands(ph, params)
    if not ph.window:
        return _grouped_layer_call(ph, sp, x, obs, quantized, None, None)
    gh, gw = ph.grid
    mask = _mask_on(gh, gw, ph.window, ph.shift, x.device)
    yw = _grouped_layer_call(ph, sp, _fold(ph, x), obs, quantized,
                             sp["bias"], mask)
    return _unfold(ph, yw, x.shape[0])


def _fold_phase(ph: Phase, bp: Any, x: torch.Tensor, inner: torch.Tensor,
                obs) -> torch.Tensor:
    """TNT re-entry: LN over each patch's flattened pixel tokens ->
    linear to the outer width -> residual into the outer stream."""
    b, t, _ = x.shape
    flat = ops.layer_norm(inner.reshape(b, t, -1), bp["fold_ln_w"],
                          bp["fold_ln_b"])
    return x + _matmul(flat, bp["fold_w"], obs, ph.site) + bp["fold_b"]


def _merge_phase(ph: Phase, sp: Any, x: torch.Tensor, obs) -> torch.Tensor:
    """Swin patch merging: 2x2 neighbourhood concat -> LN -> linear."""
    b, _, c = x.shape
    gh, gw = ph.grid
    xs = x.reshape(b, gh // 2, 2, gw // 2, 2, c)
    xs = xs.permute(0, 1, 3, 2, 4, 5).reshape(b, gh // 2, gw // 2, 4 * c)
    xs = ops.layer_norm(xs, sp["merge_ln_w"], sp["merge_ln_b"])
    xs = _matmul(xs, sp["merge_w"], obs, ph.site)
    return xs.reshape(b, (gh // 2) * (gw // 2), xs.shape[-1])


def _embed_phase(ph: Phase, params: Any, x: torch.Tensor, obs
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Patch embedding -> (outer stream, inner stream).  TNT's dual-stream
    frontend (``inner_tokens``): the sub-patches embed into the inner
    stream (+ its positional embedding), whose flattened LayerNorm seeds
    the outer stream through ``patch_embed``."""
    inner = None
    if ph.inner_tokens:
        b, t, _ = x.shape
        sub = pixel_partition(x, ph.inner_tokens)
        inner = _matmul(sub, params["pixel_embed"], obs, "pixel_embed") \
            + params["inner_pos_embed"][None]
        flat = ops.layer_norm(inner.reshape(b, t, -1), params["pe_ln_w"],
                              params["pe_ln_b"])
        x = _matmul(flat, params["patch_embed"], obs, ph.site)
    else:
        x = _matmul(x, params["patch_embed"], obs, ph.site)
        if ph.norm:
            x = ops.layer_norm(x, params["pe_ln_w"], params["pe_ln_b"])
    if ph.pos_embed:
        x = x + params["pos_embed"][None]
    return x, inner


# The phase executors of one stream, by kind: (executor, whether it takes
# the whole param tree rather than the phase's subtree).
_STREAM_PHASES = {"msa": (_msa_phase, False), "mlp": (_mlp_phase, False),
                  "layer": (_layer_phase, False),
                  "layer_group": (_layer_group_phase, True)}


def _apply_phase(sched: Schedule, ph: Phase, params: Any, x: torch.Tensor,
                 inner: Optional[torch.Tensor], obs, quantized: bool,
                 shard: Optional[ShardCtx] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Execute one phase of the control program on the executor's state,
    the (outer stream, inner stream) pair, and return the next pair.  An
    ``inner_*`` phase runs its outer twin's executor on the inner stream
    (batch axis images x patches), so the same kernels serve both streams.
    LayerNorms, folds and the float embed / fold / merge / head products
    outside the kernels are plain PyTorch, as they were plain jnp in the
    reference.  ``shard``: only the msa / mlp / layer phases hold
    model-axis shards; the embed, fold, merge and head weights replicate
    and compute full width locally."""
    kind = ph.kind
    on_inner = kind.startswith("inner_")
    if on_inner:
        kind = kind[len("inner_"):]
    if kind in _STREAM_PHASES:
        run, whole_tree = _STREAM_PHASES[kind]
        tree = params if whole_tree else _subtree(params, ph.path)
        if on_inner:
            inner = run(ph, tree, inner, obs, quantized, shard)
        else:
            x = run(ph, tree, x, obs, quantized, shard)
    elif on_inner:
        raise NotImplementedError(f"phase kind {ph.kind!r} is not ported")
    elif kind == "embed":
        x, inner = _embed_phase(ph, params, x, obs)
    elif kind == "fold":
        x = _fold_phase(ph, _subtree(params, ph.path), x, inner, obs)
    elif kind == "merge":
        x = _merge_phase(ph, _subtree(params, ph.path), x, obs)
    elif kind == "head":
        x = ops.layer_norm(x, params["ln_f_w"], params["ln_f_b"])
        x = _matmul(x.mean(dim=1), params["head"], obs, ph.site)
    else:
        raise NotImplementedError(
            f"phase kind {ph.kind!r} is not ported yet")
    return x, inner


def run_schedule(sched: Schedule, params: Any, patches: torch.Tensor,
                 observer=None, *,
                 shard: Optional[ShardCtx] = None) -> torch.Tensor:
    """Replay a compiled schedule: patches (B, N, P*P*3) -> logits.

    Float params run the float kernels; `QTensor` params plus a
    `core.quant.Calibrator` observer run the int8 PTQ path (recording
    activation amax while calibrating, frozen scales at inference).
    ``shard``: a `ShardCtx` when ``params`` are one rank's shards on a
    model-axis mesh (`build_sharded_fn`); None otherwise."""
    quantized = isinstance(params["patch_embed"], QTensor)
    x, inner = patches, None          # inner: TNT's pixel stream (B*N, m, c)
    for i, ph in enumerate(sched.phases):
        if not trace.ON:
            x, inner = _apply_phase(sched, ph, params, x, inner, observer,
                                    quantized, shard)
            continue
        with trace.span("vita.phase." + ph.kind, -1, i):
            x, inner = _apply_phase(sched, ph, params, x, inner, observer,
                                    quantized, shard)
    return x


def _phase_ms(run, device: torch.device) -> Tuple[Any, float]:
    """(result of ``run()``, its time in ms): on the card a CUDA event pair
    around the phase and a wait on the second (the device has finished
    the phase, as `block_until_ready` makes sure in the reference); on
    the CPU the host clock around it."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = run()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def profile_schedule(sched: Schedule, params: Any, patches: torch.Tensor,
                     observer=None, *, warmup: int = 1, repeats: int = 3
                     ) -> Tuple[torch.Tensor, list]:
    """Replay a schedule one phase at a time, timing each phase: logits +
    one ``{"index", "kind", "site", "ms"}`` record per phase, in schedule
    order.  ``warmup`` full replays run first (the kernels' first-call
    builds and plans), then ``repeats`` timed replays, and each phase
    keeps its best time.  The logits are the last replay's, the same
    computation as `run_schedule`.  Feed the records to
    `core.hue.live_hue_report`.

    int8 profiling needs a frozen calibrator: a recording one would
    change its scales between the replays."""
    if observer is not None and observer.frozen is None:
        raise ValueError("profiling needs frozen calibration scales "
                         "(or float mode)")
    quantized = isinstance(params["patch_embed"], QTensor)
    best = [float("inf")] * len(sched.phases)
    with torch.inference_mode():
        for it in range(max(warmup, 0) + max(repeats, 1)):
            x, inner = patches, None
            for i, ph in enumerate(sched.phases):
                (x, inner), ms = _phase_ms(
                    lambda: _apply_phase(sched, ph, params, x, inner,
                                         observer, quantized),
                    patches.device)
                if it >= warmup:
                    best[i] = min(best[i], ms)
    records = [{"index": i, "kind": ph.kind, "site": ph.site, "ms": best[i]}
               for i, ph in enumerate(sched.phases)]
    return x, records


# ---------------------------------------------------------------------------
# Fusion policy (measurement-driven fuse / don't-fuse)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FusionPolicy:
    """Decides, per served (model, mode, batch), whether the fused
    ``layer``-phase schedule or the per-phase one runs.

      * ``always`` — the fused schedule (grouped at ``default_group`` when
        a group size is configured);
      * ``never``  — the ``--no-fuse`` twin: per-phase execution;
      * ``auto``   — consult measured A/B data (``measurements`` maps
        ``(model, mode, batch) -> fusion_speedup`` of the per-layer fused
        chain; ``group_measurements`` maps the same key to
        ``(fusion_speedup, group_size)`` of the layer-group chain — both
        seeded from a bench record via `from_bench`): the policy picks
        whichever of {unfused, per-layer fused, grouped} measured fastest,
        fusing iff the winner's speedup is >= ``threshold``.  An
        exact-batch miss falls back to the nearest measured batch of the
        same (model, mode); a total miss falls back to ``default_fused``
        at ``default_group``.
    """

    mode: str = "always"
    measurements: Dict[Tuple[str, str, int], float] = \
        dataclasses.field(default_factory=dict)
    group_measurements: Dict[Tuple[str, str, int], Tuple[float, int]] = \
        dataclasses.field(default_factory=dict)
    threshold: float = 1.0
    default_fused: bool = True
    default_group: int = 1

    MODES = ("always", "never", "auto")

    def __post_init__(self):
        if self.mode not in self.MODES:
            raise ValueError(f"fusion policy mode must be one of "
                             f"{self.MODES}, got {self.mode!r}")

    @classmethod
    def from_bench(cls, record: Any, mode: str = "auto",
                   **kw) -> "FusionPolicy":
        """Seed ``auto`` measurements from a bench record (a loaded JSON
        dict, or a path to one).  Reads ``fusion_speedup`` off fused rows;
        rows without a numeric one are skipped."""
        if isinstance(record, (str, bytes)):
            with open(record) as f:
                record = json.load(f)
        meas: Dict[Tuple[str, str, int], float] = {}
        grp: Dict[Tuple[str, str, int], Tuple[float, int]] = {}
        for r in record.get("runs", []):
            fs = r.get("fusion_speedup")
            if not (r.get("fused") and isinstance(fs, (int, float))):
                continue
            key = (r["model"], r["mode"], int(r["batch"]))
            gs = int(r.get("group_size", 1))
            if gs > 1:
                grp[key] = (float(fs), gs)
            else:
                meas[key] = float(fs)
        return cls(mode=mode, measurements=meas, group_measurements=grp,
                   **kw)

    @staticmethod
    def _nearest(table, model: str, mode: str, batch: int):
        """Exact-key lookup, falling back to the nearest measured batch
        of the same (model, mode); None on a total miss."""
        key = (model, mode, int(batch))
        if key in table:
            return table[key]
        near = [(abs(b - batch), b) for (m, md, b) in table
                if m == model and md == mode]
        if near:
            return table[(model, mode, min(near)[1])]
        return None

    def decide(self, model: str, mode: str, batch: int) -> bool:
        """Fused (per-layer or grouped) vs unfused for one configuration."""
        if self.mode == "always":
            return True
        if self.mode == "never":
            return False
        s1 = self._nearest(self.measurements, model, mode, batch)
        sg = self._nearest(self.group_measurements, model, mode, batch)
        cands = [s for s in (s1, sg[0] if sg else None) if s is not None]
        if not cands:
            return self.default_fused
        return max(cands) >= self.threshold

    def decide_group(self, model: str, mode: str, batch: int) -> int:
        """Group size of the fused variant `decide` picked (1 = the
        per-layer chain).  Only meaningful when `decide` returns True."""
        if self.mode == "never":
            return 1
        if self.mode == "always":
            return self.default_group
        sg = self._nearest(self.group_measurements, model, mode, batch)
        if sg is None:
            return self.default_group if \
                self._nearest(self.measurements, model, mode, batch) \
                is None else 1
        s1 = self._nearest(self.measurements, model, mode, batch)
        spd, gs = sg
        if spd >= self.threshold and (s1 is None or spd >= s1):
            return gs
        return 1

    def decisions(self, model: str, mode: str,
                  batches: Sequence[int]) -> Dict[int, bool]:
        return {int(b): self.decide(model, mode, b) for b in batches}

    def group_decisions(self, model: str, mode: str,
                        batches: Sequence[int]) -> Dict[int, int]:
        return {int(b): self.decide_group(model, mode, b) for b in batches}


# ---------------------------------------------------------------------------
# Mesh entry (data-parallel batch grid, 2-D latency mesh)
# ---------------------------------------------------------------------------


def place_schedule_inputs(params: Any, patches: torch.Tensor, mesh):
    """This rank's executor inputs on a serving mesh: its shard of the
    param tree (float or int8; replicated over the data axis, heads and
    MLP columns split over ``model``, `vision_param_specs`) and its rows
    of the batch (its data shard when the data axis divides the batch,
    else every row), both on the rank's device."""
    return (shd.shard_vision_params(params, mesh),
            shd.shard_vision_batch(patches, mesh))


def build_sharded_fn(sched: Schedule, params: Any, mesh, *, batch: int,
                     observer=None, preprocess=None):
    """This rank's replay body on ``mesh``: ``fn(local_params, x)`` runs
    the schedule on the rank's shards (``x`` its rows of a ``batch``-row
    micro-batch, `place_schedule_inputs`) with a `ShardCtx` on a
    model-axis mesh, then gathers the whole batch's logits on every rank
    (`distributed.sharding.gather_batch`).

    ``params`` is the WHOLE tree (its shapes fix the specs the
    `ShardCtx` reads back; the body never touches its values).  The
    batch rides ``data`` when ``batch`` divides the axis and replicates
    otherwise (the batch-1 latency case: every data row computes the
    same logits while the model axis still splits the heads), fixed here
    as the reference fixes its batch spec at trace time.  ``preprocess``
    runs on the rank's rows first (the server passes patch extraction).
    int8 needs a frozen calibrator; its scales move to the rank's
    device."""
    shard = None
    if shd.axis_size(mesh, "model") > 1:
        shard = ShardCtx(mesh.model_group,
                         shd.vision_param_specs(params, mesh))
    sharded = shd.vision_batch_spec(int(batch), mesh)[0] is not None
    obs = None if observer is None else observer.to(mesh.device)

    def fn(p: Any, x: torch.Tensor) -> torch.Tensor:
        # no_grad, not inference mode: gloo copies a CUDA all-reduce's
        # result back into the tensor on its own thread, where an
        # inference tensor may not be written.
        with torch.inference_mode(False), torch.no_grad():
            if preprocess is not None:
                x = preprocess(x)
            out = run_schedule(sched, p, x, observer=obs, shard=shard)
            return shd.gather_batch(out, mesh, sharded)

    return fn


def _sharded_replay(mesh, sched: Schedule, params: Any, patches, observer):
    """One rank's part of `run_schedule_sharded`."""
    if mesh.rank is None:
        return None
    local, x = place_schedule_inputs(params, patches, mesh)
    fn = build_sharded_fn(sched, params, mesh, batch=patches.shape[0],
                          observer=observer)
    return fn(local, x)


def run_schedule_sharded(sched: Schedule, params: Any,
                         patches: torch.Tensor, mesh,
                         observer=None) -> torch.Tensor:
    """`run_schedule` distributed over a `launch.mesh.VisionMesh`: every
    rank of the mesh replays its rows on its shards of ``params`` (on a
    1-D data mesh the whole tree, with no collective until the gather;
    on a model-axis mesh the split heads and MLP columns, with the
    all-reduces of `ShardCtx`), and the logits land on rank 0's device.
    Rank 0 issues the command; the whole tree and batch travel to the
    ranks through the host.  int8 needs a frozen calibrator
    (calibration is a host-side amax loop and stays on one device)."""
    if observer is not None and observer.frozen is None:
        raise ValueError("sharded execution needs frozen calibration "
                         "scales (or float mode)")
    return mesh.call(_sharded_replay, mesh, sched, to_device(params, "cpu"),
                     patches.cpu(),
                     None if observer is None else observer.to("cpu"))

"""ViTA analytical performance model: the port's own copy of
`repro/core/perfmodel.py`, which imports no framework (the port may not
import the JAX package, so it keeps this module beside it; the results
are equal, number for number, as tests/test_torch_hue.py holds).

Re-implements the cycle-level schedule of the ViTA accelerator (Nag et al.,
cs.AR 2023) closely following Sec. III-B and Fig. 2-4:

  * Engine 1 = PE blocks 1,2,3 (each k1 x k2 MACs)  -> Q/K/V projections
  * Engine 2 = PE blocks 4,5   (each k3 x k4 MACs)  -> QK^T and S.V
  * Head-level coarse pipeline between the engines (head h vs head h-1)
  * Row-granular PE4 -> Softmax -> PE5 pipeline inside a head
  * MSA concat + MLP reuse ALL blocks; MLP uses the inter-layer optimization
    with half the MAC rows on the hidden layer and half on the output layer
  * Input-stationary / column-streamed weights with a double-buffered column
    (bandwidth check: words/cycle must stay under the DRAM budget)

`StageSpec` and `VisionModelSpec` are also the stage descriptions the
schedule compiler reads.  The cycle model prices ViTA at its 150 MHz
clock, not the card the port runs on: `core.hue` joins it with times
measured on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Hardware description
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VitaHW:
    """The ViTA accelerator configuration (Sec. III-B3 / IV)."""

    k1: int = 16
    k2: int = 6
    k3: int = 8
    k4: int = 4
    n_blocks_e1: int = 3          # PE blocks 1,2,3
    n_blocks_e2: int = 2          # PE blocks 4,5
    clock_hz: float = 150e6
    power_w: float = 0.88
    # DRAM interface: the paper states the access rate stays "well under
    # 1 word/cycle"; we take a 32-bit word against an int8 weight stream.
    dram_bytes_per_cycle: float = 4.0
    # Dedicated-unit widths (elements/cycle).  LayerNorm / Softmax follow the
    # design adapted from Lu et al. [18]; residual adder matches LN width.
    ln_width: int = 8
    softmax_width: int = 1        # row-pipelined, 1 elem/cycle after exp LUT
    softmax_latency: int = 12     # pipeline latency of the softmax unit
    requant_width: int = 16       # int32 -> int8 rescale units

    @property
    def e1_macs(self) -> int:
        return self.n_blocks_e1 * self.k1 * self.k2

    @property
    def e2_macs(self) -> int:
        return self.n_blocks_e2 * self.k3 * self.k4

    @property
    def total_macs(self) -> int:
        return self.e1_macs + self.e2_macs


# ---------------------------------------------------------------------------
# Model descriptions (vision transformers evaluated by the paper)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage of a (possibly hierarchical) vision transformer.

    The ``inner_*`` fields describe a TNT-style inner (pixel-level)
    transformer that runs before each outer block: ``inner_tokens`` pixel
    tokens of ``inner_dim`` channels per outer token, attended by
    ``inner_heads`` heads, folded back into the outer stream by a linear
    projection.  ``inner_tokens == 0`` (the default) means no inner blocks
    — plain ViT/DeiT/Swin stages are unaffected.
    """

    layers: int
    dim: int                      # latent dim D for this stage
    heads: int
    mlp_ratio: float = 4.0
    tokens: int = 0               # sequence length N seen by MSA (per window)
    n_windows: int = 1            # windows per image (Swin); 1 = global MSA
    patch_merging: bool = False   # patch-merging layer after this stage
    inner_tokens: int = 0         # TNT pixel tokens per outer token (0 = off)
    inner_dim: int = 0            # TNT pixel-embedding channels c
    inner_heads: int = 0          # TNT inner-MSA heads
    inner_mlp_ratio: float = 4.0  # TNT inner-MLP expansion
    # Per-layer head-pruning mask: ``head_mask[layer][head]`` is 1 to keep
    # the head, 0 to drop it (canonical nested-tuple form of
    # `models.config.normalize_head_mask`).  ``heads`` stays the
    # ARCHITECTURAL count (head_dim never changes under pruning); the
    # surviving count per layer is `layer_heads`.  None = dense.
    head_mask: Optional[Tuple[Tuple[int, ...], ...]] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    def layer_heads(self, layer: int) -> int:
        """Surviving MSA heads of one layer (== ``heads`` when dense)."""
        if not self.head_mask:
            return self.heads
        return int(sum(self.head_mask[layer]))

    @property
    def head_counts(self) -> Tuple[int, ...]:
        """Surviving head count per layer, in layer order."""
        return tuple(self.layer_heads(i) for i in range(self.layers))

    @property
    def mlp_hidden(self) -> int:
        return int(self.dim * self.mlp_ratio)

    @property
    def inner_head_dim(self) -> int:
        return self.inner_dim // self.inner_heads if self.inner_heads else 0

    @property
    def inner_mlp_hidden(self) -> int:
        return int(self.inner_dim * self.inner_mlp_ratio)


@dataclasses.dataclass(frozen=True)
class VisionModelSpec:
    name: str
    image: Tuple[int, int, int]
    patch: int
    stages: Tuple[StageSpec, ...]
    embed_dim: int                # dim right after patch embedding

    @property
    def patch_tokens(self) -> int:
        h, w, _ = self.image
        return (h // self.patch) * (w // self.patch)


def _vit(name: str, image: int, dim: int, heads: int, layers: int,
         mlp_ratio: float = 4.0, patch: int = 16) -> VisionModelSpec:
    tokens = (image // patch) ** 2
    stage = StageSpec(layers=layers, dim=dim, heads=heads,
                      mlp_ratio=mlp_ratio, tokens=tokens)
    return VisionModelSpec(name=name, image=(image, image, 3), patch=patch,
                           stages=(stage,), embed_dim=dim)


def vit_b16(image: int = 256) -> VisionModelSpec:
    return _vit(f"ViT-B/16@{image}", image, 768, 12, 12)


def deit_b(image: int = 224) -> VisionModelSpec:
    return _vit(f"DeiT-B@{image}", image, 768, 12, 12)


def deit_s(image: int = 224) -> VisionModelSpec:
    return _vit(f"DeiT-S@{image}", image, 384, 6, 12)


def deit_t(image: int = 224) -> VisionModelSpec:
    return _vit(f"DeiT-T@{image}", image, 192, 3, 12)


def tnt_s(image: int = 224) -> VisionModelSpec:
    """TNT-S (Han et al. 2021): 16x16 patches, each split into 16 4x4-pixel
    sub-patches; inner transformer at c=24 / 4 heads, outer at D=384 / 6
    heads, 12 layers.  The inner blocks are global MSA over 16 tokens,
    batched over every patch — the same batch-fold trick the schedule uses
    for Swin windows."""
    tokens = (image // 16) ** 2
    stage = StageSpec(layers=12, dim=384, heads=6, mlp_ratio=4.0,
                      tokens=tokens, inner_tokens=16, inner_dim=24,
                      inner_heads=4, inner_mlp_ratio=4.0)
    return VisionModelSpec(name=f"TNT-S@{image}", image=(image, image, 3),
                           patch=16, stages=(stage,), embed_dim=384)


def swin_t(image: int = 224) -> VisionModelSpec:
    """Swin-T: patch 4, window 7, depths (2,2,6,2), dims 96..768."""
    depths = (2, 2, 6, 2)
    dims = (96, 192, 384, 768)
    heads = (3, 6, 12, 24)
    window = 7
    base = image // 4             # 56 for 224
    stages = []
    for i, (l, d, h) in enumerate(zip(depths, dims, heads)):
        side = base // (2 ** i)
        stages.append(StageSpec(
            layers=l, dim=d, heads=h, mlp_ratio=4.0,
            tokens=window * window,
            n_windows=(side // window) ** 2,
            patch_merging=(i < 3),
        ))
    return VisionModelSpec(name=f"Swin-T@{image}", image=(image, image, 3),
                           patch=4, stages=tuple(stages), embed_dim=96)


PAPER_MODELS: Dict[str, VisionModelSpec] = {
    "vit_b16_256": vit_b16(256),
    "vit_b16_224": vit_b16(224),
    "deit_b_224": deit_b(224),
    "deit_s_224": deit_s(224),
    "deit_t_224": deit_t(224),
    "swin_t_224": swin_t(224),
    "tnt_s_224": tnt_s(224),
}


# ---------------------------------------------------------------------------
# MAC counting (Table III)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MacBreakdown:
    msa: int = 0
    mlp: int = 0
    patch_merging: int = 0
    patch_embed: int = 0

    @property
    def counted(self) -> int:
        """MACs the paper's Table III counts (ignores patch embedding)."""
        return self.msa + self.mlp + self.patch_merging

    @property
    def total(self) -> int:
        return self.counted + self.patch_embed

    def fractions(self) -> Dict[str, float]:
        c = float(self.counted)
        return {
            "msa": self.msa / c,
            "mlp": self.mlp / c,
            "patch_merging": self.patch_merging / c,
        }


def stage_msa_macs(s: StageSpec, k: Optional[int] = None) -> int:
    """MSA MACs for one layer of a stage: QKV + QK^T + SV + concat.

    ``k`` is the surviving head count of the layer (default: dense);
    head_dim is architectural, so QKV/attention scale linearly in k and
    the concat contraction narrows to ``k * head_dim``."""
    n, d, dh = s.tokens, s.dim, s.head_dim
    k = s.heads if k is None else k
    per_window = (3 * n * d * dh + 2 * n * n * dh) * k + n * (k * dh) * d
    return per_window * s.n_windows


def stage_mlp_macs(s: StageSpec) -> int:
    n = s.tokens * s.n_windows
    return 2 * n * s.dim * s.mlp_hidden


def stage_inner_msa_macs(s: StageSpec) -> int:
    """TNT inner-block MSA MACs for one layer: the inner MSA runs per outer
    token (a batch of s.tokens "windows" of inner_tokens pixels), plus the
    fold projection (inner_tokens*c -> D) that re-enters the outer stream —
    counted here with the concat projection, its structural analogue."""
    if not s.inner_tokens:
        return 0
    m, c = s.inner_tokens, s.inner_dim
    per_token = 3 * m * c * c + 2 * m * m * c + m * c * c
    fold = (m * c) * s.dim
    return (per_token + fold) * s.tokens * s.n_windows


def stage_inner_mlp_macs(s: StageSpec) -> int:
    if not s.inner_tokens:
        return 0
    m = s.inner_tokens * s.tokens * s.n_windows
    return 2 * m * s.inner_dim * s.inner_mlp_hidden


def stage_patch_merging_macs(s: StageSpec) -> int:
    if not s.patch_merging:
        return 0
    # 2x2 neighbourhood concat (4C) -> linear to 2C over T/4 output tokens.
    t_out = s.tokens * s.n_windows // 4
    return t_out * (4 * s.dim) * (2 * s.dim)


def count_macs(m: VisionModelSpec) -> MacBreakdown:
    b = MacBreakdown()
    h, w, c = m.image
    b.patch_embed = m.patch_tokens * (c * m.patch * m.patch) * m.embed_dim
    for s in m.stages:
        b.msa += sum(stage_msa_macs(s, k) for k in s.head_counts) \
            + s.layers * stage_inner_msa_macs(s)
        b.mlp += s.layers * (stage_mlp_macs(s) + stage_inner_mlp_macs(s))
        b.patch_merging += stage_patch_merging_macs(s)
    return b


# ---------------------------------------------------------------------------
# Cycle model (Table IV)
# ---------------------------------------------------------------------------


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class PhaseCycles:
    name: str
    cycles: float
    useful_macs: float
    weight_bytes: float = 0.0
    bw_stall: float = 0.0

    @property
    def total(self) -> float:
        return self.cycles + self.bw_stall


@dataclasses.dataclass
class PerfReport:
    model: str
    hw: VitaHW
    phases: List[PhaseCycles]
    total_cycles: float = 0.0
    useful_macs: float = 0.0
    hue: float = 0.0
    fps: float = 0.0
    latency_s: float = 0.0
    energy_j: float = 0.0
    peak_words_per_cycle: float = 0.0

    def row(self) -> Dict[str, float]:
        return {"hue": self.hue, "fps": self.fps, "energy_j": self.energy_j,
                "latency_s": self.latency_s}


def _gemm_cycles_rowcol(rows: int, contract: int, cols: int,
                        pe_rows: int, pe_cols: int, n_blocks: int) -> float:
    """Cycles for a (rows x contract) @ (contract x cols) GEMM on an array of
    ``n_blocks`` PE blocks of pe_rows x pe_cols MACs.

    ViTA's dataflow: rows of the stationary input map onto PE rows (groups of
    ``pe_rows``), weight columns stream; each block processes ``pe_cols``
    columns concurrently (rows share weights).  Ceil-granularity on both the
    row groups and the column groups models the remainder under-utilization
    (e.g. N=196 on k1=16 rows -> 94.2% row efficiency).
    """
    row_passes = _ceil(rows, pe_rows)
    col_groups = _ceil(cols, pe_cols * n_blocks)
    return float(row_passes) * float(col_groups) * float(contract)


def msa_phase(hw: VitaHW, s: StageSpec,
              k: Optional[int] = None) -> List[PhaseCycles]:
    """Head-pipelined MSA (Fig. 4) for one layer of a stage.

    ``k`` overrides the head count for head-pruned layers: the head
    pipeline runs k iterations and the concat projection contracts over
    the surviving ``k * head_dim`` columns only (the width the executor's
    sliced ``w_msa`` actually has)."""
    n, d, dh = s.tokens, s.dim, s.head_dim
    k = s.heads if k is None else k
    # ---- Engine 1: Q, K, V for one head.  PE blocks 1..3 each handle one of
    # Q/K/V (same shape) -> per-block GEMM (n x d) @ (d x dh).
    e1 = _gemm_cycles_rowcol(n, d, dh, hw.k1, hw.k2, 1)
    # ---- Engine 2: PE4 computes QK^T rows, PE5 computes S.V rows behind it.
    # Row-granular pipeline: per q-row, PE4 does (n x dh) MACs on k3*k4 units.
    qkt_row = _ceil(n * dh, hw.k3 * hw.k4)
    sv_row = qkt_row
    softmax_row = hw.softmax_latency + _ceil(n, max(hw.softmax_width, 1))
    row_slot = max(qkt_row, sv_row, softmax_row)
    e2 = float(_ceil(n, 1)) * row_slot + sv_row + softmax_row  # + drain
    # ---- Head pipeline across k heads: fill + steady state + drain.
    slot = max(e1, e2)
    msa_core = e1 + (k - 1) * slot + e2
    useful = k * (3 * n * d * dh + 2 * n * n * dh)
    # Weight traffic: 3 * d * dh int8 weights per head (Q,K,V columns).
    wbytes = float(k * 3 * d * dh)
    phases = [PhaseCycles("msa_heads", msa_core * s.n_windows,
                          useful * s.n_windows, wbytes)]
    # ---- Concat projection W^msa (n x k*dh) @ (k*dh x d), all blocks
    # reused; pruned layers contract only the surviving concat width.
    cc = _gemm_cycles_rowcol(n, k * dh, d, hw.k1, hw.k2, hw.n_blocks_e1)
    # Engine-2 blocks help with a proportional share (paper: "reuse the same
    # PE blocks"): scale cycles by MAC share actually usable.
    cc = cc * (hw.e1_macs / hw.total_macs)
    phases.append(PhaseCycles("msa_concat", cc * s.n_windows,
                              float(n * k * dh * d) * s.n_windows,
                              float(k * dh * d)))
    return phases


def mlp_phase(hw: VitaHW, s: StageSpec) -> PhaseCycles:
    """Inter-layer optimized MLP (Fig. 3): half rows hidden, half output."""
    n = s.tokens * s.n_windows
    d, m = s.dim, s.mlp_hidden
    half_rows = max(hw.k1 // 2, 1)
    # Stage 1 GEMM (n x d) @ (d x m) on half the rows of every block; stage 2
    # GEMM (n x m) @ (m x d) on the other half, one hidden column behind.
    s1 = _gemm_cycles_rowcol(n, d, m, half_rows, hw.k2, hw.n_blocks_e1)
    s2 = _gemm_cycles_rowcol(n, m, d, half_rows, hw.k2, hw.n_blocks_e1)
    # Engine-2 blocks join as additional column capacity (share of MACs).
    eff = hw.total_macs / hw.e1_macs
    cycles = max(s1, s2) / eff + d  # +d: drain of the last hidden column
    useful = float(2 * n * d * m)
    wbytes = float(2 * d * m)
    return PhaseCycles("mlp", cycles, useful, wbytes)


def aux_phase(hw: VitaHW, s: StageSpec) -> PhaseCycles:
    """LayerNorm x2, residual x2, requant passes — serial dedicated units."""
    n = s.tokens * s.n_windows
    d = s.dim
    ln = 2 * _ceil(n * d, hw.ln_width)
    res = 2 * _ceil(n * d, hw.ln_width)
    rq = 2 * _ceil(n * d, hw.requant_width)
    return PhaseCycles("aux", float(ln + res + rq), 0.0, 0.0)


def inner_stage(s: StageSpec) -> StageSpec:
    """The TNT inner transformer as a stage of its own: global MSA over
    ``inner_tokens`` pixel tokens, batched over every outer token — the
    n_windows slot carries the batch fold, exactly as the schedule runs it."""
    assert s.inner_tokens, "stage has no inner transformer"
    return StageSpec(layers=1, dim=s.inner_dim, heads=s.inner_heads,
                     mlp_ratio=s.inner_mlp_ratio, tokens=s.inner_tokens,
                     n_windows=s.tokens * s.n_windows)


def fold_phase(hw: VitaHW, s: StageSpec) -> PhaseCycles:
    """TNT fold projection: (tokens x m*c) @ (m*c x D) back into the outer
    stream — structurally the concat projection of the inner transformer."""
    n = s.tokens * s.n_windows
    contract = s.inner_tokens * s.inner_dim
    cyc = _gemm_cycles_rowcol(n, contract, s.dim, hw.k1, hw.k2,
                              hw.n_blocks_e1)
    cyc = cyc * (hw.e1_macs / hw.total_macs)
    return PhaseCycles("fold", cyc, float(n * contract * s.dim),
                       float(contract * s.dim))


def patch_merging_phase(hw: VitaHW, s: StageSpec) -> PhaseCycles:
    t_out = s.tokens * s.n_windows // 4
    cyc = _gemm_cycles_rowcol(t_out, 4 * s.dim, 2 * s.dim,
                              hw.k1, hw.k2, hw.n_blocks_e1)
    cyc = cyc * (hw.e1_macs / hw.total_macs)
    return PhaseCycles("patch_merging", cyc,
                       float(t_out * 4 * s.dim * 2 * s.dim),
                       float(4 * s.dim * 2 * s.dim))


def patch_embed_phase(hw: VitaHW, m: VisionModelSpec) -> PhaseCycles:
    h, w, c = m.image
    contract = c * m.patch * m.patch
    cyc = _gemm_cycles_rowcol(m.patch_tokens, contract, m.embed_dim,
                              hw.k1, hw.k2, hw.n_blocks_e1)
    cyc = cyc * (hw.e1_macs / hw.total_macs)
    return PhaseCycles("patch_embed", cyc,
                       float(m.patch_tokens * contract * m.embed_dim),
                       float(contract * m.embed_dim))


def analyze(m: VisionModelSpec, hw: Optional[VitaHW] = None) -> PerfReport:
    hw = hw or VitaHW()
    phases: List[PhaseCycles] = [patch_embed_phase(hw, m)]
    for s in m.stages:
        for li in range(s.layers):
            if s.inner_tokens:             # TNT: inner blocks + fold first
                inn = inner_stage(s)
                phases.extend(msa_phase(hw, inn))
                phases.extend([mlp_phase(hw, inn), aux_phase(hw, inn),
                               fold_phase(hw, s)])
            phases.extend(msa_phase(hw, s, s.layer_heads(li)))
            phases.extend([mlp_phase(hw, s), aux_phase(hw, s)])
        if s.patch_merging:
            phases.append(patch_merging_phase(hw, s))
    # Bandwidth stalls: weights stream during compute; stall if a phase needs
    # more than dram_bytes_per_cycle on average (double-buffered columns hide
    # latency but not throughput).
    peak = 0.0
    for p in phases:
        if p.weight_bytes and p.cycles:
            need = p.weight_bytes / p.cycles
            peak = max(peak, need)
            min_cycles = p.weight_bytes / hw.dram_bytes_per_cycle
            p.bw_stall = max(0.0, min_cycles - p.cycles)
    total_cycles = sum(p.total for p in phases)
    useful = sum(p.useful_macs for p in phases)
    hue = useful / (hw.total_macs * total_cycles)
    latency = total_cycles / hw.clock_hz
    return PerfReport(
        model=m.name, hw=hw, phases=phases, total_cycles=total_cycles,
        useful_macs=useful, hue=hue, fps=1.0 / latency, latency_s=latency,
        energy_j=hw.power_w * latency,
        peak_words_per_cycle=peak / 4.0,
    )


# ---------------------------------------------------------------------------
# Schedule-level phase attribution (fused vs per-phase execution)
# ---------------------------------------------------------------------------
#
# `analyze` prices the paper's accelerator, whose phases already overlap.
# The schedule *executor* additionally chooses between per-phase execution
# (each msa / mlp a separate kernel, the (T, D) activation round-tripping
# through off-chip memory at the boundary) and the fused `layer` phases of
# `fuse_schedule` (one kernel chain, no boundary traffic).  The functions
# below attribute expected cycles to each *schedule* phase kind so serving
# can report measured-vs-modelled fusion speedup per model.


def phase_boundary_cycles(hw: VitaHW, s: StageSpec,
                          inner: bool = False) -> float:
    """Cycles to write + re-read the fp32 activation at one msa->mlp phase
    boundary — the off-chip round-trip the fused layer phase elides."""
    if inner:
        n = s.inner_tokens * s.tokens * s.n_windows
        d = s.inner_dim
    else:
        n = s.tokens * s.n_windows
        d = s.dim
    return 2.0 * n * d * 4.0 / hw.dram_bytes_per_cycle


def layer_launch_cycles(hw: VitaHW, s: StageSpec,
                        inner: bool = False) -> float:
    """Idle cycles at one fused-layer boundary: the kernel (re)launch
    window during which the NEXT layer's first-head Q/K/V weight blocks
    must load before its head pipeline can start — 3 int8 weight columns
    of ``dim x head_dim`` over the DRAM interface.  The layer-group
    megakernel hides this window behind the previous layer's MLP tail
    (revolving-buffer prefetch); per-layer chains pay it at every block
    boundary."""
    if inner:
        d, dh = s.inner_dim, s.inner_head_dim
    else:
        d, dh = s.dim, s.head_dim
    return 3.0 * d * dh / hw.dram_bytes_per_cycle


def stage_groupable(s: StageSpec) -> bool:
    """Whether `fuse_schedule`'s grouping pass can form multi-layer groups
    in this stage: TNT stages interleave inner blocks and fold re-entry
    between outer layers (never adjacent), and multi-window Swin stages
    alternate plain/shifted blocks (adjacent layers differ in shift).
    Single-window stages — columnar ViT/DeiT and Swin's final stages —
    group freely."""
    return s.layers > 1 and not s.inner_tokens and s.n_windows == 1


def head_segments(counts: Sequence[int]) -> List[int]:
    """Lengths of the maximal runs of equal surviving-head counts — the
    exact boundaries `fuse_schedule`'s grouping pass splits layer groups
    at (`_groupable` requires equal ``Phase.heads``), so the grouping
    plan of a ragged stage is per-segment, not per-stage."""
    segs: List[int] = []
    last = None
    for c in counts:
        if segs and c == last:
            segs[-1] += 1
        else:
            segs.append(1)
        last = c
    return segs


def _stage_group_plan(layers: int, group_size: int):
    """(layers_in_groups, plain_layers, n_launches) for one groupable
    stage chunked greedily into groups of at most ``group_size`` — the
    exact chunking `fuse_schedule` performs (a leftover chunk of one
    stays a plain per-layer phase)."""
    if group_size <= 1:
        return 0, layers, layers
    chunks = [group_size] * (layers // group_size)
    if layers % group_size:
        chunks.append(layers % group_size)
    grouped = sum(c for c in chunks if c > 1)
    return grouped, layers - grouped, len(chunks)


def expected_phase_cycles(m: VisionModelSpec,
                          hw: Optional[VitaHW] = None, *,
                          fused: bool = False,
                          group_size: int = 1) -> Dict[str, float]:
    """Expected cycles per `core.schedule` phase KIND for one image.

    Keys mirror the compiled schedule: ``embed / msa / mlp / merge /
    inner_msa / inner_mlp / fold`` unfused, with each msa+mlp pair
    replaced by ``layer`` (and ``inner_layer``) when ``fused``.  Unfused
    pairs carry the boundary round-trip (split between the two halves,
    like the aux LN/residual/requant passes); fused layers elide it.

    ``group_size > 1`` (fused only) relabels the layers that
    `fuse_schedule` would collapse into ``layer_group`` phases under that
    key — the totals are conserved exactly (grouping moves work between
    kinds, it never changes it); the cycles grouping *reclaims* are the
    separate launch-window account of `total_launch_cycles` /
    `grouping_speedup_model`, which the per-kind table deliberately
    leaves out so fused-vs-grouped tables stay comparable row by row.
    """
    hw = hw or VitaHW()
    out: Dict[str, float] = {}

    def add(kind: str, cycles: float) -> None:
        out[kind] = out.get(kind, 0.0) + float(cycles)

    def add_pair(kind_msa: str, kind_mlp: str, kind_layer: str,
                 msa_cs: Sequence[float], mlp_c: float, aux_c: float,
                 bnd: float, groupable: bool = False) -> None:
        # ``msa_cs`` is per-layer (head pruning makes layers unequal);
        # grouping chunks per equal-head segment, mirroring `_groupable`.
        layers = len(msa_cs)
        if fused:
            per_layer = [mc + mlp_c + aux_c for mc in msa_cs]
            if groupable and group_size > 1:
                i = 0
                for seg in head_segments(msa_cs):
                    grouped, plain, _ = _stage_group_plan(seg, group_size)
                    if grouped:
                        add(kind_layer + "_group",
                            per_layer[i] * grouped)
                    if plain:
                        add(kind_layer, per_layer[i] * plain)
                    i += seg
            else:
                add(kind_layer, sum(per_layer))
        else:
            add(kind_msa, sum(msa_cs) + (aux_c / 2 + bnd / 2) * layers)
            add(kind_mlp, (mlp_c + aux_c / 2 + bnd / 2) * layers)

    add("embed", patch_embed_phase(hw, m).cycles)
    for s in m.stages:
        if s.inner_tokens:
            inn = inner_stage(s)
            add_pair("inner_msa", "inner_mlp", "inner_layer",
                     [sum(p.cycles for p in msa_phase(hw, inn))] * s.layers,
                     mlp_phase(hw, inn).cycles, aux_phase(hw, inn).cycles,
                     phase_boundary_cycles(hw, s, inner=True))
            add("fold", fold_phase(hw, s).cycles * s.layers)
        add_pair("msa", "mlp", "layer",
                 [sum(p.cycles for p in msa_phase(hw, s, k))
                  for k in s.head_counts],
                 mlp_phase(hw, s).cycles, aux_phase(hw, s).cycles,
                 phase_boundary_cycles(hw, s),
                 groupable=stage_groupable(s))
        if s.patch_merging:
            add("merge", patch_merging_phase(hw, s).cycles)
    return out


def expected_phase_macs(m: VisionModelSpec,
                        hw: Optional[VitaHW] = None, *,
                        fused: bool = False,
                        group_size: int = 1) -> Dict[str, float]:
    """Useful MACs per `core.schedule` phase KIND for one image.

    The MAC twin of `expected_phase_cycles` (same keys): where that table
    attributes *time*, this one attributes *work*, so the two divide into
    a per-phase-kind HUE — useful MACs / (total MAC capacity x cycles) —
    the quantity the paper's Table IV reports per model and the live
    profiler (`core.hue`) reports per phase.  Fusion moves MACs between
    keys (msa+mlp -> layer) but never changes the total: boundary
    round-trips and the aux LN/residual/requant passes are pure overhead.
    ``group_size`` relabels the groupable share to ``layer_group`` exactly
    as `expected_phase_cycles` does — MACs, too, are conserved.
    """
    hw = hw or VitaHW()
    out: Dict[str, float] = {}

    def add(kind: str, macs: float) -> None:
        out[kind] = out.get(kind, 0.0) + float(macs)

    def add_pair(kind_msa: str, kind_mlp: str, kind_layer: str,
                 msa_ms: Sequence[float], mlp_m: float,
                 groupable: bool = False) -> None:
        layers = len(msa_ms)
        if fused:
            per_layer = [mm + mlp_m for mm in msa_ms]
            if groupable and group_size > 1:
                i = 0
                for seg in head_segments(msa_ms):
                    grouped, plain, _ = _stage_group_plan(seg, group_size)
                    if grouped:
                        add(kind_layer + "_group",
                            per_layer[i] * grouped)
                    if plain:
                        add(kind_layer, per_layer[i] * plain)
                    i += seg
            else:
                add(kind_layer, sum(per_layer))
        else:
            add(kind_msa, sum(msa_ms))
            add(kind_mlp, mlp_m * layers)

    add("embed", patch_embed_phase(hw, m).useful_macs)
    for s in m.stages:
        if s.inner_tokens:
            inn = inner_stage(s)
            add_pair("inner_msa", "inner_mlp", "inner_layer",
                     [sum(p.useful_macs for p in msa_phase(hw, inn))]
                     * s.layers,
                     mlp_phase(hw, inn).useful_macs)
            add("fold", fold_phase(hw, s).useful_macs * s.layers)
        add_pair("msa", "mlp", "layer",
                 [sum(p.useful_macs for p in msa_phase(hw, s, k))
                  for k in s.head_counts],
                 mlp_phase(hw, s).useful_macs,
                 groupable=stage_groupable(s))
        if s.patch_merging:
            add("merge", patch_merging_phase(hw, s).useful_macs)
    return out


def total_boundary_cycles(m: VisionModelSpec,
                          hw: Optional[VitaHW] = None) -> float:
    """All msa->mlp (and inner) phase-boundary round-trip cycles of one
    image — the cycles `fuse_schedule` reclaims (equivalently: the exact
    difference between the unfused and fused `expected_phase_cycles`
    totals)."""
    hw = hw or VitaHW()
    return sum(
        s.layers * (phase_boundary_cycles(hw, s)
                    + (phase_boundary_cycles(hw, s, inner=True)
                       if s.inner_tokens else 0.0))
        for s in m.stages)


def fusion_speedup_model(m: VisionModelSpec,
                         hw: Optional[VitaHW] = None) -> Dict[str, float]:
    """Modelled end-to-end speedup of the fused schedule over the per-phase
    one (the analytic counterpart of the bench's measured
    ``fusion_speedup``): the only difference between the two totals is the
    elided per-layer activation round-trips, so the ratio isolates the
    phase-boundary cost."""
    unfused = sum(expected_phase_cycles(m, hw, fused=False).values())
    fused = sum(expected_phase_cycles(m, hw, fused=True).values())
    return {
        "unfused_cycles": unfused,
        "fused_cycles": fused,
        "modelled_speedup": unfused / fused,
    }


def total_launch_cycles(m: VisionModelSpec,
                        hw: Optional[VitaHW] = None, *,
                        group_size: int = 1) -> float:
    """Kernel-launch / first-weight-load idle cycles of one image through
    the FUSED schedule at the given layer-group size: one
    `layer_launch_cycles` window per emitted layer(-group) phase.  At
    ``group_size=1`` every fused layer pays the window; grouping
    amortises each stage down to one window per greedy chunk (the
    megakernel streams layer i+1's Q/K/V during layer i's MLP tail).
    Inner (TNT) blocks are never grouped and always pay per layer."""
    hw = hw or VitaHW()
    total = 0.0
    for s in m.stages:
        if s.inner_tokens:
            total += s.layers * layer_launch_cycles(hw, s, inner=True)
        g = group_size if stage_groupable(s) else 1
        n_launches = 0
        for seg in head_segments(s.head_counts):
            _, _, nl = _stage_group_plan(seg, g)
            n_launches += nl
        total += n_launches * layer_launch_cycles(hw, s)
    return total


def grouping_speedup_model(m: VisionModelSpec,
                           hw: Optional[VitaHW] = None, *,
                           group_size: int = 4) -> Dict[str, float]:
    """Modelled end-to-end speedup of the layer-group megakernel over the
    per-layer fused chain (the analytic counterpart of the bench's
    grouped ``speedup_vs_fused``): compute cycles are identical, so the
    ratio isolates the reclaimed per-boundary launch windows."""
    hw = hw or VitaHW()
    compute = sum(expected_phase_cycles(m, hw, fused=True).values())
    fused = compute + total_launch_cycles(m, hw, group_size=1)
    grouped = compute + total_launch_cycles(m, hw, group_size=group_size)
    return {
        "fused_cycles": fused,
        "grouped_cycles": grouped,
        "launch_cycles_reclaimed": fused - grouped,
        "modelled_speedup": fused / grouped,
    }


# ---------------------------------------------------------------------------
# Paper reference values for validation (Tables III, IV, V)
# ---------------------------------------------------------------------------

PAPER_TABLE3 = {  # model -> (msa%, mlp%, patch_merging%)
    "vit_b16_256": (36.8, 63.2, 0.0),
    "vit_b16_224": (36.1, 63.9, 0.0),
    "deit_s_224": (38.6, 61.4, 0.0),
    "deit_t_224": (43.1, 56.9, 0.0),
    "swin_t_224": (31.9, 63.8, 4.3),
}

PAPER_TABLE4 = {  # model -> (hue%, fps, energy J)
    "vit_b16_256": (93.2, 2.17, 0.406),
    "vit_b16_224": (92.8, 2.75, 0.320),
    "deit_s_224": (87.2, 9.36, 0.094),
    "deit_t_224": (66.2, 19.01, 0.046),
    "swin_t_224": (81.0, 8.71, 0.101),
}

PAPER_TABLE5 = {  # accelerator -> (power W, fps, fps/W) for DeiT-B @224
    "row_wise_acc_asic40nm": (None, 44.5, None),
    "auto_vit_acc_fpga16nm": (9.40, 25.9, 2.76),
    "vita_fpga28nm": (0.88, 2.75, 3.12),
}

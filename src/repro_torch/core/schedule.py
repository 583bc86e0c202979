"""ViTA control program (counterpart of `repro/core/schedule.py`).

`compile_schedule` turns a `VisionModelSpec` into the phase list the
executor replays; `fuse_schedule` collapses each msa + mlp pair of one
encoder block into a fused ``layer`` phase; `run_schedule` replays a
schedule over the port's kernels.  This slice covers the columnar (ViT /
DeiT) layout: ``embed``, one fused ``layer`` per block, ``head``.  Float
layers run the fused float kernel; int8 layers run the fused int8 kernel
at the frozen calibration scales, and fall back to the unfused int8 MSA
and MLP while the calibrator is still recording, so it sees every
intermediate activation.

Windowed (Swin) and TNT phases, layer groups, the unfused float executor
and sharding come with later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.core.perfmodel import VisionModelSpec
from repro_torch.core.quant import INT8_MAX, QTensor
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gelu, layer_norm_ref


@dataclasses.dataclass(frozen=True)
class Phase:
    """One control-program step.  ``path`` addresses the param subtree the
    phase reads; ``site`` prefixes its activation-calibration entries."""

    kind: str                      # embed | msa | mlp | layer | head
    path: Tuple[Any, ...]
    site: str
    grid: Tuple[int, int]          # (h, w) token grid at phase input
    heads: int = 0                 # surviving heads of this layer
    pos_embed: bool = False        # embed: add the positional embedding


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


def compile_schedule(spec: VisionModelSpec, *, n_classes: int) -> Schedule:
    """Compile a columnar model spec (one global-MSA stage, no inner
    blocks) into embed, msa/mlp per block, head."""
    if (len(spec.stages) != 1 or spec.stages[0].n_windows != 1
            or spec.stages[0].patch_merging or spec.stages[0].inner_tokens):
        raise NotImplementedError(
            "only the columnar (ViT/DeiT) layout is ported yet")
    img_h, img_w, _ = spec.image
    if img_h != img_w:
        raise ValueError("the control program assumes square images")
    side = img_h // spec.patch
    st = spec.stages[0]
    if int(math.isqrt(st.tokens)) != side:
        raise ValueError(f"stage token grid {st.tokens} != {side}x{side}")
    phases = [Phase(kind="embed", path=(), site="patch_embed",
                    grid=(side, side), pos_embed=True)]
    for li in range(st.layers):
        path, site = ("layers", li), f"l{li}"
        phases.append(Phase(kind="msa", path=path, site=site,
                            grid=(side, side), heads=st.layer_heads(li)))
        phases.append(Phase(kind="mlp", path=path, site=site,
                            grid=(side, side)))
    phases.append(Phase(kind="head", path=(), site="head", grid=(side, side)))
    return Schedule(name=spec.name, image=img_h, patch=spec.patch,
                    n_classes=n_classes, phases=tuple(phases))


FUSABLE_PAIRS = {("msa", "mlp"): "layer"}


def fuse_schedule(sched: Schedule, *, group_size: int = 1) -> Schedule:
    """Collapse adjacent msa -> mlp phases of one block (same path, site
    and grid) into fused ``layer`` phases.  Layer groups
    (``group_size > 1``) are not ported yet."""
    if group_size != 1:
        raise NotImplementedError("layer groups are not ported yet")
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
    return dataclasses.replace(sched, phases=tuple(fused))


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def _subtree(params: Any, path: Tuple[Any, ...]) -> Any:
    node = params
    for k in path:
        node = node[k]
    return node


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
    return x @ w


def _head_scale(wq: QTensor) -> torch.Tensor:
    """Per-(head, out-channel) scale (H, 1, Dh) -> the (H, Dh) kernel form."""
    h, _, dh = wq.values.shape
    return wq.scale.reshape(h, dh)


def _per_head_msa(bp: Any, z: torch.Tensor, obs, site: str) -> torch.Tensor:
    """int8 per-head MSA over (B, N, C) -> (B, N, H*Dh), heads merged."""
    b, n, _ = z.shape
    scale = obs.observe(f"{site}.qkv_in", z)
    sa = ops.vita_msa_int8(
        _quant(z, scale), bp["wq"].values, bp["wk"].values, bp["wv"].values,
        scale, _head_scale(bp["wq"]), _head_scale(bp["wk"]),
        _head_scale(bp["wv"]))
    h, dh = sa.shape[1], sa.shape[3]
    return sa.permute(0, 2, 1, 3).reshape(b, n, h * dh).to(z.dtype)


def _msa_phase(ph: Phase, bp: Any, x: torch.Tensor, obs) -> torch.Tensor:
    """Unfused int8 MSA phase: LN -> per-head MSA -> concat -> residual."""
    z = layer_norm_ref(x, bp["ln1_w"], bp["ln1_b"])
    sa = _per_head_msa(bp, z, obs, ph.site)
    return x + _matmul(sa, bp["w_msa"], obs, f"{ph.site}.w_msa")


def _mlp_phase(ph: Phase, bp: Any, x: torch.Tensor, obs) -> torch.Tensor:
    """Unfused int8 MLP phase: LN -> up -> GELU -> down -> residual."""
    h = layer_norm_ref(x, bp["ln2_w"], bp["ln2_b"])
    hid = gelu(_matmul(h, bp["w_up"], obs, f"{ph.site}.w_up") + bp["b_up"])
    y = _matmul(hid, bp["w_down"], obs, f"{ph.site}.w_down") + bp["b_down"]
    return x + y


def _fused_layer_call(ph: Phase, bp: Any, x: torch.Tensor, obs,
                      quantized: bool) -> torch.Tensor:
    """One fused encoder layer over (B, N, C)."""
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
            bp["ln2_b"], bp["b_up"], bp["b_down"]).to(x.dtype)
    return ops.vita_layer_fused(
        x, bp["wq"], bp["wk"], bp["wv"], bp["w_msa"], bp["ln1_w"],
        bp["ln1_b"], bp["ln2_w"], bp["ln2_b"], bp["w_up"], bp["b_up"],
        bp["w_down"], bp["b_down"])


def _layer_phase(ph: Phase, bp: Any, x: torch.Tensor, obs,
                 quantized: bool) -> torch.Tensor:
    """Fused encoder layer.  int8 calibration (observer not yet frozen)
    falls back to the unfused executors so the observer sees every
    intermediate activation at the sites the fused kernel later reads."""
    if quantized and (obs is None or obs.frozen is None):
        x = _msa_phase(ph, bp, x, obs)
        return _mlp_phase(ph, bp, x, obs)
    return _fused_layer_call(ph, bp, x, obs, quantized)


def _apply_phase(sched: Schedule, ph: Phase, params: Any, x: torch.Tensor,
                 obs, quantized: bool) -> torch.Tensor:
    """Execute one phase of the control program."""
    if ph.kind == "embed":
        x = _matmul(x, params["patch_embed"], obs, ph.site)
        if ph.pos_embed:
            x = x + params["pos_embed"][None]
    elif ph.kind == "layer":
        x = _layer_phase(ph, _subtree(params, ph.path), x, obs, quantized)
    elif ph.kind == "head":
        # LayerNorm outside the layers is plain PyTorch, as it was plain
        # jnp in the reference.
        x = layer_norm_ref(x, params["ln_f_w"], params["ln_f_b"])
        x = _matmul(x.mean(dim=1), params["head"], obs, ph.site)
    else:
        raise NotImplementedError(
            f"phase kind {ph.kind!r} is not ported yet (the port replays "
            f"fused schedules)")
    return x


def run_schedule(sched: Schedule, params: Any, patches: torch.Tensor,
                 observer=None) -> torch.Tensor:
    """Replay a compiled schedule: patches (B, N, P*P*3) -> logits.

    Float params run the float kernels; `QTensor` params plus a
    `core.quant.Calibrator` observer run the int8 PTQ path (recording
    activation amax while calibrating, frozen scales at inference)."""
    quantized = isinstance(params["patch_embed"], QTensor)
    x = patches
    for ph in sched.phases:
        x = _apply_phase(sched, ph, params, x, observer, quantized)
    return x

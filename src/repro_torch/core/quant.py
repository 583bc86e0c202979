"""int8 post-training quantization (counterpart of `repro/core/quant.py`).

Symmetric int8 (zero point 0): per-(head, out-channel) for the per-head
QKV stacks, per-output-channel for plain matmul weights, per-tensor for
activations, with max-abs calibration (optionally a percentile).  The
arithmetic follows the JAX module step for step, so the same float
weights give the same int8 codes and scales.

The generic tree PTQ (`quantize_params`, `quantized_linear`) runs on any
param tree.  On an LM tree it keeps the JAX package's stacked-leaf rule:
JAX stacks each pattern position's layers into one leaf, so a weight's
per-channel scale is shared by those layers and a per-layer vector counts
one rank more; ``pattern_len`` regroups the port's flat layer list the
same way (`optim.compress.stack_key`).

Head pruning is applied to the params, not the executor: the per-head
stacks are sliced to the surviving heads and the concat projection's rows
with them (the H/K rescale folded into the float rows, or into an int8
weight's per-channel scale), so the kernels size their head axis off
``wq.shape`` and never see a dead head.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels import ops, ref
from repro_torch.optim.compress import stack_key

INT8_MAX = 127.0


@dataclasses.dataclass
class QTensor:
    """int8 ``values`` + float32 ``scale`` broadcastable against them."""

    values: torch.Tensor
    scale: torch.Tensor

    def to(self, device) -> "QTensor":
        return QTensor(self.values.to(device), self.scale.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return self.values.to(dtype) * self.scale.to(dtype)

    @property
    def shape(self):
        return self.values.shape


def _percentile(a: torch.Tensor, p: float, dim=None) -> torch.Tensor:
    """`jnp.percentile(a, p, axis=dim, keepdims=dim is not None)` with its
    linear interpolation, in its float32 arithmetic: q = p * ((1 / 100)
    * (n - 1)) (XLA folds the division by 100 and the product with
    n - 1 into one constant, and that rounds differently from
    p / 100 * (n - 1)), the values at floor(q) and ceil(q) of the sorted
    reduction (picked by `torch.kthvalue`: `torch.quantile` refuses more
    than 2^24 elements) weighted by 1 - (q - floor q) and q - floor q
    and summed as XLA's CPU backend sums them (bit for bit over the whole
    tensor; over axes XLA's vectorised loops round the sum either way,
    within 1 ulp); returns a's dtype."""
    if dim is None:
        flat = a.reshape(-1)
    else:
        dims = (dim,) if isinstance(dim, int) else tuple(dim)
        dims = tuple(d % a.dim() for d in dims)
        keep = [d for d in range(a.dim()) if d not in dims]
        flat = a.permute(*keep, *dims).reshape(
            [a.shape[d] for d in keep] + [-1])
    f32 = torch.float32
    n = torch.tensor(flat.shape[-1], dtype=f32)
    q = torch.tensor(p, dtype=f32) * (1 / torch.tensor(100, dtype=f32)
                                      * (n - 1))
    low, high = torch.floor(q), torch.ceil(q)
    high_weight = q - low
    low_weight = 1 - high_weight
    lo = int(torch.clamp(low, 0, n - 1)) + 1
    hi = int(torch.clamp(high, 0, n - 1)) + 1
    low_value = torch.kthvalue(flat, lo, dim=-1).values
    high_value = torch.kthvalue(flat, hi, dim=-1).values
    # XLA contracts the weighted sum into a fused multiply-add (one
    # rounding of high * w_high + round(low * w_low)); float64 holds the
    # product exactly and rounds the sum once.
    low_part = low_value.to(f32) * low_weight.to(a.device)
    out = (high_value.double() * high_weight.double().to(a.device)
           + low_part.double()).to(f32).to(a.dtype)
    if dim is not None:
        shape = [1 if d in dims else s for d, s in enumerate(a.shape)]
        out = out.reshape(shape)
    return out


def amax_scale(x: torch.Tensor, dim=None, percentile: Optional[float] = None,
               eps: float = 1e-8) -> torch.Tensor:
    """Symmetric scale from max-abs (optionally a percentile) statistics
    (keepdims over ``dim``), in x's dtype."""
    a = x.abs()
    if percentile is not None:
        amax = _percentile(a, percentile, dim)
    else:
        amax = a.amax() if dim is None else a.amax(dim=dim, keepdim=True)
    return torch.clamp(amax, min=eps) / INT8_MAX


def quantize(x: torch.Tensor, scale: torch.Tensor) -> QTensor:
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return QTensor(q, scale.float())


def quantize_per_channel(w: torch.Tensor) -> QTensor:
    """Per-output-channel (last axis) symmetric quantization of a weight
    matrix."""
    return quantize(w, amax_scale(w, dim=tuple(range(w.ndim - 1))))


def quantize_per_tensor(x: torch.Tensor,
                        percentile: Optional[float] = None) -> QTensor:
    return quantize(x, amax_scale(x, percentile=percentile))


# ---------------------------------------------------------------------------
# Quantized linear
# ---------------------------------------------------------------------------


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 over x's last dim and w's first (any leading
    dims of x), exact on either device."""
    return ref.int8_matmul_ref(x_q, w_q)


def _kernel_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """`ops.int8_matmul` (kernel 4 on the card, its plain version on the
    CPU) over x's leading dims flattened into rows."""
    acc = ops.int8_matmul(x_q.reshape(-1, x_q.shape[-1]).contiguous(),
                          w_q.contiguous())
    return acc.reshape(*x_q.shape[:-1], w_q.shape[-1])


def quantized_linear(x: torch.Tensor, wq: QTensor,
                     bias: Optional[torch.Tensor], act_scale: torch.Tensor,
                     *, out_dtype: torch.dtype = torch.float32,
                     matmul: Callable = _kernel_matmul) -> torch.Tensor:
    """y = dequant(int8(x) @ wq) + bias at a static (calibrated)
    per-tensor ``act_scale``.  x is divided by the scale in their promoted
    dtype (JAX's promotion: a float32 scale lifts bf16 x), rounded half to
    even and clipped to int8; the int32 accumulator comes from ``matmul``
    (default: kernel 4, with no fused rescale) and is rescaled outside it
    in JAX's order, acc * (act_scale * w_scale), in ``out_dtype``."""
    dt = torch.promote_types(x.dtype, act_scale.dtype)
    xq = torch.clamp(torch.round(x.to(dt) / act_scale.to(dt)), -INT8_MAX,
                     INT8_MAX).to(torch.int8)
    acc = matmul(xq, wq.values)
    y = acc.to(out_dtype) * (act_scale.to(out_dtype) *
                             wq.scale.to(out_dtype))
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y


# ---------------------------------------------------------------------------
# Whole-model PTQ
# ---------------------------------------------------------------------------

_WEIGHT_NAMES = frozenset({"kernel", "w", "wi", "wo", "wq", "wk", "wv",
                           "w_up", "w_gate", "w_down", "embedding", "w_qkv",
                           "w_out", "head"})


def is_weight_leaf(path: Tuple, leaf: torch.Tensor) -> bool:
    """The JAX package's heuristic: a float leaf of rank 2 or more whose
    key names a matmul weight."""
    if leaf.dim() < 2 or not leaf.dtype.is_floating_point:
        return False
    return str(path[-1]) in _WEIGHT_NAMES


def quantize_params(params: Any, predicate: Callable = is_weight_leaf,
                    pattern_len: Optional[int] = None) -> Any:
    """Every leaf ``predicate(path, leaf)`` picks becomes a per-output-
    channel `QTensor`.  With ``pattern_len`` (an LM tree: ``len(
    cfg.pattern)``) the leaves of ``layers`` are regrouped as JAX stacks
    them: the layers of one pattern position are stacked, the predicate
    sees the stack under its JAX path (`stack_key`), and the stack is
    quantized as one leaf, so its layers share one scale per channel;
    each layer keeps its slice of the codes and the scale without the
    stacked dim."""
    groups: Dict[Tuple, list] = {}
    for path, leaf in tree_lib.leaves_with_path(params):
        key = stack_key(path, pattern_len) if pattern_len else path
        groups.setdefault(key, []).append((path, leaf))
    out = {}
    for key, members in groups.items():
        stacked = bool(pattern_len) and "layers" in key
        leaves = [leaf for _, leaf in members]
        view = torch.stack(leaves) if stacked else leaves[0]
        if not predicate(key, view):
            out.update(members)
            continue
        q = quantize_per_channel(view)
        for i, (path, _) in enumerate(members):
            out[path] = QTensor(q.values[i], q.scale[0]) if stacked else q
    return tree_lib.map_with_path(lambda path, _: out[path], params)


def dequantize_params(params: Any) -> Any:
    """Every `QTensor` leaf back to float32 (values * scale)."""
    return tree_lib.tree_map(
        lambda leaf: leaf.dequantize() if isinstance(leaf, QTensor)
        else leaf, params)


def quant_error_bound(x: torch.Tensor, scale: torch.Tensor) -> float:
    """The round-trip bound |x - dq(q(x))| <= scale / 2 (unclipped)."""
    return float(torch.max(scale) / 2.0)


_PER_HEAD_KEYS = frozenset({"wq", "wk", "wv"})
_PER_CHANNEL_KEYS = frozenset({"patch_embed", "head", "w_msa", "w_up",
                               "w_down", "merge_w", "pixel_embed", "fold_w"})


def quantize_vision_params(params: Any) -> Any:
    """int8 PTQ of a ViT, Swin or TNT param tree: per-head ``wq/wk/wv``
    stacks reduce over the contraction dim D only (scale (H, 1, Dh));
    ``patch_embed``, ``head``, ``w_msa``, ``w_up``, ``w_down``, Swin's
    ``merge_w`` and TNT's ``pixel_embed`` and ``fold_w`` are per output
    channel (scale (1, N)); norms, biases, the relative-position bias
    tables and the positional embeddings (outer and inner) stay float.
    TNT nests its inner and outer blocks as subtrees with the same key
    names, so the recursion covers both streams' stacks."""

    def _q(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in _PER_HEAD_KEYS:
                    out[k] = quantize(v, amax_scale(v, dim=(1,)))
                elif k in _PER_CHANNEL_KEYS:
                    out[k] = quantize_per_channel(v)
                elif isinstance(v, (dict, list)):
                    out[k] = _q(v)
                else:
                    out[k] = v
            return out
        if isinstance(node, list):
            return [_q(v) for v in node]
        return node

    return _q(params)


def stack_qtensors(qts: Sequence[QTensor]) -> QTensor:
    """Stack per-layer `QTensor`s into one leading-axis (L, ...) QTensor
    (values and scales stacked separately), the layer-group kernel's
    operand form: each member keeps its own per-channel scales."""
    return QTensor(torch.stack([q.values for q in qts]),
                   torch.stack([q.scale for q in qts]))


class Calibrator:
    """Per-site activation amax, recorded during calibration forwards.

    ``observe(name, x)`` records max|x| while calibrating (a host sync per
    call) and returns the running scale; once frozen it returns the frozen
    0-d float32 scale, which lives on the calibrator's device."""

    def __init__(self):
        self.amax: Dict[str, float] = {}
        self.frozen: Optional[Dict[str, torch.Tensor]] = None
        self._stacks: Dict[Tuple[str, ...], torch.Tensor] = {}

    def observe(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.frozen is not None:
            return self.frozen[name]
        a = float(x.abs().amax())
        self.amax[name] = max(self.amax.get(name, 0.0), a)
        return torch.tensor(max(self.amax[name], 1e-8) / INT8_MAX,
                            dtype=torch.float32, device=x.device)

    def freeze(self, device="cpu") -> Dict[str, torch.Tensor]:
        self.frozen = {k: torch.tensor(max(v, 1e-8) / INT8_MAX,
                                       dtype=torch.float32, device=device)
                       for k, v in self.amax.items()}
        self._stacks = {}
        return self.frozen

    def stacked(self, names: Tuple[str, ...]) -> torch.Tensor:
        """The frozen scales of ``names`` as one (len(names),) tensor,
        made once per frozen calibrator and reused (the layer-group
        kernel's act_scales)."""
        out = self._stacks.get(names)
        if out is None:
            out = torch.stack([self.frozen[n] for n in names]).reshape(-1)
            self._stacks[names] = out
        return out

    def to(self, device) -> "Calibrator":
        """A frozen copy whose scales live on ``device``."""
        if self.frozen is None:
            raise RuntimeError("only a frozen calibrator can move devices")
        out = Calibrator()
        out.amax = dict(self.amax)
        out.frozen = {k: v.to(device) for k, v in self.frozen.items()}
        return out


# The PTQ acceptance gate shared with the reference:
# max|logit_float - logit_int8| <= PTQ_REL_TOL * max|logit_float| + PTQ_ABS_TOL
PTQ_REL_TOL = 0.1
PTQ_ABS_TOL = 0.05


def ptq_tolerance(float_logit_scale: float) -> float:
    """Tolerance on int8 logit error, given max|float logits|."""
    return PTQ_REL_TOL * float(float_logit_scale) + PTQ_ABS_TOL


# ---------------------------------------------------------------------------
# Head pruning
# ---------------------------------------------------------------------------


def _keep_indices(mask_row) -> Tuple[int, ...]:
    return tuple(i for i, v in enumerate(mask_row) if v)


def _take(t: torch.Tensor, keep, dim: int) -> torch.Tensor:
    idx = torch.tensor(list(keep), dtype=torch.long, device=t.device)
    return torch.index_select(t, dim, idx)


def slice_head_stack(leaf, keep):
    """A per-head (H, ...) stack (tensor or `QTensor`, whose (H, 1, Dh)
    scale follows its values) cut to the surviving heads ``keep``."""
    if isinstance(leaf, QTensor):
        return QTensor(_take(leaf.values, keep, 0), _take(leaf.scale, keep, 0))
    return _take(leaf, keep, 0)


def slice_concat_rows(w_msa, keep, n_heads: int):
    """The (H*Dh, C) concat projection cut to the surviving heads' row
    blocks, with the H/K rescale folded in: float rows are multiplied by
    H/K; an int8 weight keeps its codes and multiplies its per-channel
    scale by H/K."""
    keep = list(keep)
    k = len(keep)
    rescale = n_heads / float(k)
    if isinstance(w_msa, QTensor):
        hd, c = w_msa.values.shape
        vals = _take(w_msa.values.reshape(n_heads, hd // n_heads, c), keep, 0)
        return QTensor(vals.reshape(-1, c), w_msa.scale * rescale)
    hd, c = w_msa.shape
    rows = _take(w_msa.reshape(n_heads, hd // n_heads, c), keep, 0)
    return rows.reshape(-1, c) * rescale


def prune_block_heads(bp: Dict[str, Any], mask_row) -> Dict[str, Any]:
    """One block's params pruned to a head-mask row: ``wq/wk/wv`` stacks,
    Swin's ``rel_bias`` head columns and the ``w_msa`` concat rows (H/K
    rescale folded in).  An all-keep row returns the block unchanged."""
    keep = _keep_indices(mask_row)
    n_heads = len(tuple(mask_row))
    if len(keep) == n_heads:
        return bp
    out = dict(bp)
    for name in ("wq", "wk", "wv"):
        out[name] = slice_head_stack(bp[name], keep)
    if "rel_bias" in bp:
        out["rel_bias"] = _take(bp["rel_bias"], keep, 1)
    out["w_msa"] = slice_concat_rows(bp["w_msa"], keep, n_heads)
    return out


def expand_block_heads(bp: Dict[str, Any], mask_row) -> Dict[str, Any]:
    """Inverse of `prune_block_heads`, the dense oracle of a pruned block:
    zero heads (unit scales in int8) and zero concat rows at the dead
    positions, so the H-head schedule computes what the pruned one does
    (up to the order of a float sum)."""
    keep = _keep_indices(mask_row)
    n_heads = len(tuple(mask_row))
    if len(keep) == n_heads:
        return bp
    idx = list(keep)

    def pad(t: torch.Tensor, dim: int, fill: float) -> torch.Tensor:
        shape = list(t.shape)
        shape[dim] = n_heads
        full = torch.full(shape, fill, dtype=t.dtype, device=t.device)
        full.index_copy_(dim, torch.tensor(idx, device=t.device), t)
        return full

    def pad_stack(leaf):
        if isinstance(leaf, QTensor):
            return QTensor(pad(leaf.values, 0, 0), pad(leaf.scale, 0, 1.0))
        return pad(leaf, 0, 0.0)

    out = dict(bp)
    for name in ("wq", "wk", "wv"):
        out[name] = pad_stack(bp[name])
    if "rel_bias" in bp:
        out["rel_bias"] = pad(bp["rel_bias"], 1, 0.0)
    w = bp["w_msa"]
    vals = w.values if isinstance(w, QTensor) else w
    kd, c = vals.shape
    rows = pad(vals.reshape(len(keep), kd // len(keep), c), 0, 0
               ).reshape(-1, c)
    out["w_msa"] = QTensor(rows, w.scale) if isinstance(w, QTensor) else rows
    return out

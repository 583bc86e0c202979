"""Device dispatch for the port's kernels (counterpart of
`repro/kernels/ops.py`).

There is no backend switch: the tensor decides.  A CUDA tensor launches
the port's Hopper kernel (or raises — nothing falls back), a CPU tensor
takes the plain PyTorch version in `ref`.  `LAUNCHES` holds one plain
integer per kernel, bumped only where the kernel is launched, so a run can
show that its main path went through the kernels; `MODE_LAUNCHES` splits
the launches of the kernels with dtype modes (`ref.PORTED_MODES`) by
(kernel, activation dtype, weight dtype), so it can show which of their
instantiations ran (the int8 layers by their LN vectors' dtype).

Gradients: when a CUDA input of `attention`, `mlp`, `linear_recurrence`
or `vita_layer_fused` (kernels 9, 6, 11 and 1: LM and vision training)
requires grad and grad mode is on, the call goes through `_KernelGrad`: its
forward launches the Hopper kernel (counted as any launch) and its
backward differentiates the kernel's plain version, recomputed on the
saved inputs.  The backward is plain PyTorch because the JAX package has
no backward kernel: no `custom_vjp` wraps any of its `pallas_call`s, and
its training step differentiates the `ref.py` oracles, so this is the
JAX package's own gradient, not a fallback.  The forward never gives way
to the plain version, and a kernel that fails still raises.  Calls that
take no gradient (serving, `no_grad`, `inference_mode`) launch the
kernel directly, as before.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import trace as _trace

from . import fused_mlp as _fused_mlp
from . import head_attention as _head_attention
from . import int8_matmul as _int8_matmul
from . import ref
from . import rglru_scan as _rglru_scan
from . import vita_layer as _vita_layer
from . import vita_layer_group as _vita_layer_group
from . import vita_msa as _vita_msa

LAUNCHES: Dict[str, int] = {"vita_layer": 0, "vita_layer_int8": 0,
                            "vita_msa_int8": 0, "int8_matmul": 0,
                            "vita_msa_batched": 0, "fused_mlp": 0,
                            "vita_layer_group": 0,
                            "vita_layer_group_int8": 0,
                            "flash_attention": 0, "decode_attention": 0,
                            "rglru_scan": 0}
MODE_LAUNCHES: Dict[Tuple[str, str, str], int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    MODE_LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    """A copy of this process's `LAUNCHES` (what a mesh rank reports)."""
    return dict(LAUNCHES)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _on_card(name: str, t: torch.Tensor,
             w: Optional[torch.Tensor] = None) -> bool:
    """True for a CUDA tensor (and counts one launch of ``name``, and of
    its (t's dtype, w's dtype) mode where ``w`` is given), False for a CPU
    or meta tensor (the plain version: on meta it computes shapes only,
    the dry run's trace); any other device raises."""
    if t.is_cuda:
        LAUNCHES[name] += 1
        if w is not None:
            key = (name, _dtype_name(t), _dtype_name(w))
            MODE_LAUNCHES[key] = MODE_LAUNCHES.get(key, 0) + 1
        return True
    if t.device.type not in ("cpu", "meta"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return False


class _KernelGrad(torch.autograd.Function):
    """Forward: ``kernel(*inputs, **kw)``; backward: the gradient of
    ``plain(*inputs, **kw)`` (module docstring).  ``inputs`` may hold
    None (an absent bias)."""

    @staticmethod
    def forward(ctx, kernel, plain, kw, *inputs):
        ctx.plain, ctx.kw = plain, kw
        ctx.save_for_backward(*inputs)
        return kernel(*inputs, **kw)

    @staticmethod
    def backward(ctx, grad):
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad[3:])]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            out = ctx.plain(*inputs, **ctx.kw)
        got = iter(torch.autograd.grad(out, wanted, grad))
        return (None, None, None) + tuple(
            next(got) if t is not None and t.requires_grad else None
            for t in inputs)


def _launch(kernel, plain, kw: dict, *inputs):
    """The kernel on the card's ``inputs``, through `_KernelGrad` where a
    gradient will be taken."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _KernelGrad.apply(kernel, plain, kw, *inputs)
    return kernel(*inputs, **kw)


def layer_norm(x, w, b, eps: float = 1e-5):
    """LayerNorm in float32 returning x's dtype: the counterpart of
    `repro/kernels/ops.py::layer_norm`, plain PyTorch on either device (it
    never was a Pallas kernel)."""
    return ref.layer_norm_ref(x, w, b, eps).to(x.dtype)


def int8_matmul(x_q, w_q, x_scale=None, w_scale=None, out_dtype=None):
    """(M, K) int8 . (K, N) int8 -> int32, or float32 rescaled by
    x_scale * w_scale[n]."""
    if _on_card("int8_matmul", x_q):
        return _int8_matmul.int8_matmul(x_q, w_q, x_scale, w_scale, out_dtype)
    return ref.int8_matmul_ref(x_q, w_q, x_scale, w_scale, out_dtype)


def vita_msa_int8(z_q, wq_q, wk_q, wv_q, x_scale, wq_scale, wk_scale,
                  wv_scale, bias=None, mask=None, qkv_bias=None):
    """int8 per-head MSA: (B, N, D) int8 -> (B, H, N, Dh) float32."""
    args = (z_q, wq_q, wk_q, wv_q, x_scale, wq_scale, wk_scale, wv_scale,
            bias, mask, qkv_bias)
    if _on_card("vita_msa_int8", z_q):
        return _vita_msa.vita_msa_int8(*args)
    return ref.vita_msa_int8_ref(*args)


def vita_msa_batched(z, wq, wk, wv, bias=None, mask=None, qkv_bias=None):
    """Float per-head MSA: (B, N, D) -> (B, H, N, Dh).  ``bias`` (H, N, N)
    and ``mask`` (nW, N, N) select the windowed (Swin) mode; ``qkv_bias``
    (3, H, Dh) is the optional per-head projection bias."""
    if _on_card("vita_msa_batched", z, wq):
        return _vita_msa.vita_msa_batched(z, wq, wk, wv, bias, mask,
                                          qkv_bias)
    return ref.vita_msa_batched_ref(z, wq, wk, wv, bias, mask, qkv_bias)


def vita_msa(z, wq, wk, wv):
    """One image: (N, D) -> (H, N, Dh)."""
    return vita_msa_batched(z[None], wq, wk, wv)[0]


def mlp(x, w1, w2, b1=None, b2=None, w_gate=None, *, activation="gelu"):
    """The fused MLP act(x W1 + b1) W2 + b2, or gated
    act(x W_gate) * (x W1 + b1) W2 + b2, with the hidden activation never
    materialised on the card; x's dtype in and out."""
    if _on_card("fused_mlp", x, w1):
        return _launch(_fused_mlp.fused_mlp, _mlp_plain,
                       {"activation": activation}, x, w1, w2, b1, b2, w_gate)
    return _mlp_plain(x, w1, w2, b1, b2, w_gate, activation=activation)


def _mlp_plain(x, w1, w2, b1, b2, w_gate, *, activation):
    """`ref.fused_mlp_ref` in the kernel wrapper's argument order."""
    return ref.fused_mlp_ref(x, w1, b1, w2, b2, activation=activation,
                             w_gate=w_gate)


def vita_layer_fused(x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b,
                     w_up, b_up, w_down, b_down, bias=None, mask=None, *,
                     msa_axis=None, mlp_axis=None):
    """One fused float encoder layer: (B, N, D) -> (B, N, D).  On local
    shards ``msa_axis`` / ``mlp_axis`` (process groups) all-reduce the
    concat and down partials; on the card the kernel chain splits there."""
    args = (x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b, w_up, b_up,
            w_down, b_down, bias, mask)
    axes = {"msa_axis": msa_axis, "mlp_axis": mlp_axis}
    with _trace.span("vita.kernels.vita_layer", a0=x.shape[1],
                     a1=x.shape[0]):
        if _on_card("vita_layer", x, wq):
            return _launch(_vita_layer.vita_layer, ref.vita_layer_ref, axes,
                           *args)
        return ref.vita_layer_ref(*args, **axes)


def vita_layer_int8(x, wq_q, wk_q, wv_q, wmsa_q, wup_q, wdown_q,
                    act_scales, wq_scale, wk_scale, wv_scale, wmsa_scale,
                    wup_scale, wdown_scale, ln1_w, ln1_b, ln2_w, ln2_b,
                    b_up, b_down, bias=None, mask=None, *, msa_axis=None,
                    mlp_axis=None):
    """Fused int8 encoder layer with the requant chain at the frozen
    ``act_scales`` = [qkv_in, w_msa, w_up, w_down]; axes as in
    `vita_layer_fused`."""
    args = (x, wq_q, wk_q, wv_q, wmsa_q, wup_q, wdown_q, act_scales,
            wq_scale, wk_scale, wv_scale, wmsa_scale, wup_scale, wdown_scale,
            ln1_w, ln1_b, ln2_w, ln2_b, b_up, b_down, bias, mask)
    axes = {"msa_axis": msa_axis, "mlp_axis": mlp_axis}
    with _trace.span("vita.kernels.vita_layer", a0=x.shape[1],
                     a1=x.shape[0]):
        if _on_card("vita_layer_int8", x, ln1_w):
            return _vita_layer.vita_layer_int8(*args, **axes)
        return ref.vita_layer_int8_ref(*args, **axes)


def vita_layer_group(x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b,
                     w_up, b_up, w_down, b_down, bias=None, mask=None):
    """L fused float encoder layers with stacked (L, ...) operands in one
    kernel launch: (B, N, D) -> (B, N, D)."""
    args = (x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b, w_up, b_up,
            w_down, b_down, bias, mask)
    if _on_card("vita_layer_group", x, wq):
        return _vita_layer_group.vita_layer_group(*args)
    return ref.vita_layer_group_ref(*args)


def vita_layer_group_int8(x, wq_q, wk_q, wv_q, wmsa_q, wup_q, wdown_q,
                          act_scales, wq_scale, wk_scale, wv_scale,
                          wmsa_scale, wup_scale, wdown_scale, ln1_w, ln1_b,
                          ln2_w, ln2_b, b_up, b_down, bias=None, mask=None):
    """L fused int8 encoder layers in one launch, each member at its own
    frozen ``act_scales`` row of (L, 4)."""
    args = (x, wq_q, wk_q, wv_q, wmsa_q, wup_q, wdown_q, act_scales,
            wq_scale, wk_scale, wv_scale, wmsa_scale, wup_scale, wdown_scale,
            ln1_w, ln1_b, ln2_w, ln2_b, b_up, b_down, bias, mask)
    if _on_card("vita_layer_group_int8", x, ln1_w):
        return _vita_layer_group.vita_layer_group_int8(*args)
    return ref.vita_layer_group_int8_ref(*args)


def attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """LM attention: q (B, Hq, Nq, Dh) over k, v (B, Hkv, Nk, Dh) (GQA),
    causal and sliding-window masks, query i at position i + q_offset."""
    kw = {"causal": causal, "window": window, "q_offset": q_offset}
    if _on_card("flash_attention", q):
        return _launch(_head_attention.flash_attention, ref.attention_ref,
                       kw, q, k, v)
    return ref.attention_ref(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, lengths):
    """One query per sequence, q (B, Hq, Dh), over a KV cache
    (B, Hkv, S, Dh) masked by ``lengths`` (B,) int32."""
    if _on_card("decode_attention", q):
        return _head_attention.decode_attention(q, k_cache, v_cache, lengths)
    return ref.decode_attention_ref(q, k_cache, v_cache, lengths)


def linear_recurrence(a, b):
    """h_t = a_t * h_{t-1} + b_t along axis 1 of (B, T, W) (the RG-LRU
    hot loop), h carried in float32."""
    if _on_card("rglru_scan", a):
        return _launch(_rglru_scan.rglru_scan, ref.linear_recurrence_ref,
                       {}, a, b)
    return ref.linear_recurrence_ref(a, b)

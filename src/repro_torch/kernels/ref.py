"""Plain PyTorch versions of the port's kernels (counterpart of
`repro/kernels/ref.py`).

Each function repeats the arithmetic of the JAX oracle of the same name.
They are the CPU path of `ops`, and `chip_smoke.py` runs them on the card
as the yardstick the CUDA kernels are held against.  Nothing on the main
path calls them when a card is present.

The layers' ``msa_axis`` / ``mlp_axis`` are the reference's mesh axes: on
a model-axis mesh each rank holds its local shards (its heads and their
concat rows, its MLP columns and down rows) and the axis is the process
group to all-reduce the row-parallel partial over (`psum`), where the
reference names a `shard_map` axis.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

INT8_MAX = 127.0
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` (tanh approximation), written out in its own order."""
    inner = _SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))
    cdf = 0.5 * (1.0 + torch.tanh(inner))
    return x * cdf


_gelu = gelu     # for functions whose ``gelu`` argument is a flag


def layer_norm_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm, population variance (returns fp32)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y * w.float() + b.float()


def quant(v: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8: clip(round_half_even(v / scale), +-127)."""
    return torch.clamp(torch.round(v / scale), -INT8_MAX, INT8_MAX
                       ).to(torch.int8)


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                    x_scale: Optional[torch.Tensor] = None,
                    w_scale: Optional[torch.Tensor] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """int8 x int8 -> int32, optionally rescaled to float.

    PyTorch has no integer matmul on CUDA, so the product is taken in
    float64 and cast back: every |acc| <= K * 127**2 is far below 2**53,
    so the result is exact on either device."""
    acc = torch.matmul(x_q.double(), w_q.double()).to(torch.int32)
    if x_scale is None and w_scale is None:
        return acc if out_dtype is None else acc.to(out_dtype)
    s = torch.ones((), dtype=torch.float32, device=acc.device)
    if x_scale is not None:
        s = s * x_scale.float()
    if w_scale is not None:
        s = s * w_scale.float()
    return (acc.float() * s).to(out_dtype or torch.float32)


def gemm_i8_ref(a: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype,
                x_scale: Optional[torch.Tensor] = None,
                w_scale: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                res: Optional[torch.Tensor] = None, gelu: bool = False,
                out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 GEMM building block of the int8 layers
    (`int8_matmul.launch_gemm_i8`): a (M, K) int8 against ``w``, a (K, N)
    int8 matrix or a per-head (H, K, Dh) stack (column h*Dh + e is w[h, :,
    e]); ``out_dtype`` int32 gives the exact sum, float32 acc * (x_scale *
    w_scale) [+ bias] [-> gelu] [res +] with each step rounded on its own,
    int8 that value quantised at ``out_scale``."""
    if w.dim() == 3:
        w = w.permute(1, 0, 2).reshape(w.shape[1], -1)
    acc = int8_matmul_ref(a, w)
    if out_dtype == torch.int32:
        return acc
    s = torch.ones((), dtype=torch.float32, device=acc.device)
    if x_scale is not None:
        s = s * x_scale.float()
    if w_scale is not None:
        s = s * w_scale.float()
    v = acc.float() * s
    if bias is not None:
        v = v + bias.float()
    if gelu:
        v = _gelu(v)
    if res is not None:
        v = res + v
    return v if out_dtype == torch.float32 else quant(v, out_scale)


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` summed over the ranks of process group ``axis`` (an
    all-reduce, in place on a contiguous ``x``); ``x`` itself when
    ``axis`` is None."""
    if axis is None:
        return x
    x = x.contiguous()
    dist.all_reduce(x, group=axis)
    return x


def _window_extra(s: torch.Tensor, bias: Optional[torch.Tensor],
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Add the relative-position bias (H, n, n) and the per-window mask
    (nW, n, n) to scores (B', H, n, n); batch row i is window i % nW."""
    if bias is not None:
        s = s + bias.float()[None]
    if mask is not None:
        n_w = mask.shape[0]
        s = s + mask.float().repeat(s.shape[0] // n_w, 1, 1)[:, None]
    return s


def softmax_av(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               scale: float, bias: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """QK^T * scale [+ bias[h] + mask[i % nW]] -> max-subtracted softmax
    (divide by the row sum) -> .V over the last two axes (engine 2 of
    `repro/kernels/vita_msa.py`, windowed mode included), in float32; P
    and V are rounded to ``out_dtype`` before the AV product, as the TPU
    kernel's `softmax_av` does (a no-op for float32)."""
    if (bias is None) != (mask is None):
        raise ValueError("windowed mode needs both bias and mask")
    s = _window_extra(torch.matmul(q, k.transpose(-1, -2)) * scale, bias,
                      mask)
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p.to(out_dtype).float(), v.to(out_dtype).float())


def _qkv_with_bias(q, k, v, qkv_bias: Optional[torch.Tensor]):
    """Add the optional (3, H, Dh) per-head Q/K/V projection bias to
    (B, H, N, Dh) projections (after the requant on the int8 path)."""
    if qkv_bias is None:
        return q, k, v
    qb = qkv_bias.float()[:, None, :, None, :]           # (3, 1, H, 1, Dh)
    return q + qb[0], k + qb[1], v + qb[2]


# The (activation dtype, weight dtype) modes the vision kernels run, as
# the TPU kernels do: float32 throughout; float32 activations with bf16
# weights (the server's mixed mode, fp32 math on exactly upcast weights);
# bf16 throughout (`forward` on bf16 patches).
PORTED_MODES = ((torch.float32, torch.float32),
                (torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.bfloat16))


def check_mode(name: str, act: torch.Tensor, *weights) -> torch.dtype:
    """The weights' dtype, after checking that every weight (None skipped)
    shares it and that (act's dtype, it) is one of `PORTED_MODES`; any
    other combination raises NotImplementedError."""
    dts = {w.dtype for w in weights if w is not None}
    mode = (act.dtype, *dts)
    if mode not in PORTED_MODES:
        raise NotImplementedError(
            f"{name}: activations {act.dtype} with weights "
            f"{sorted(map(str, dts))} is not a ported mode (float32 / "
            f"float32, float32 / bfloat16, bfloat16 / bfloat16)")
    return mode[1]


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.relu(x))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# The MLP activations of `repro/kernels/ref.py::act_fn` (the kernel's
# activation codes follow this order, `ACTIVATION_CODES`).
ACTIVATIONS = {"gelu": gelu, "relu": torch.relu, "relu2": _relu2,
               "silu": _silu, "identity": lambda x: x}
ACTIVATION_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}


def act_fn(name: str):
    """The activation ``name`` (``gelu`` is the tanh form, like
    `jax.nn.gelu`); raises for a name the MLP does not know."""
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; known: "
                         f"{', '.join(ACTIVATIONS)}")
    return ACTIVATIONS[name]


def fused_mlp_ref(x: torch.Tensor, w1: torch.Tensor,
                  b1: Optional[torch.Tensor], w2: torch.Tensor,
                  b2: Optional[torch.Tensor], *, activation: str = "gelu",
                  w_gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out = act(x @ w1 + b1) @ w2 + b2 over (..., D) -> (..., D_out), or
    gated, h = act(x @ w_gate) * (x @ w1 + b1).  Products and sums in
    float32; the hidden activation is rounded to x's dtype before the
    second product, as the TPU kernel does (`fused_mlp.py:59`), and the
    output is returned in x's dtype.  Modes: `PORTED_MODES`."""
    act = act_fn(activation)
    check_mode("fused_mlp", x, w1, b1, w2, b2, w_gate)
    xf = x.float()
    h = torch.matmul(xf, w1.float())
    if b1 is not None:
        h = h + b1.float()
    if w_gate is not None:
        h = act(torch.matmul(xf, w_gate.float())) * h
    else:
        h = act(h)
    out = torch.matmul(h.to(x.dtype).float(), w2.float())
    if b2 is not None:
        out = out + b2.float()
    return out.to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """LM attention in float32: q (B, Hq, Nq, Dh), k/v (B, Hkv, Nk, Dh)
    with Hq % Hkv == 0 (GQA).  Query i sits at position i + ``q_offset``
    and sees key j where j <= i + q_offset (causal) and j > i + q_offset
    - ``window`` (sliding window); a row with no such key gives 0.
    Returns q's dtype."""
    b, hq, nq, dh = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    group = hq // hkv
    scale = scale if scale is not None else dh ** -0.5
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kr.transpose(-1, -2)) * scale
    qpos = torch.arange(nq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(nk, device=q.device)[None, :]
    mask = torch.ones((nq, nk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    return torch.matmul(p, vr).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """One query per sequence over a KV cache, in float32: q (B, Hq, Dh),
    caches (B, Hkv, S, Dh), key j of sequence b valid where j <
    lengths[b]; a sequence of length 0 gives 0 (`repro/kernels/ops.py`'s
    masked reference).  Returns q's dtype."""
    b, hq, dh = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    kr = k_cache.float().repeat_interleave(group, dim=1)
    vr = v_cache.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), kr) * (dh ** -0.5)
    valid = (torch.arange(s_max, device=q.device)[None, None]
             < lengths.to(q.device)[:, None, None])
    scores = scores.masked_fill(~valid, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    return torch.einsum("bhk,bhkd->bhd", p, vr).to(q.dtype)


def linear_recurrence_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 of (B, T, W), h_{-1} = 0,
    carried in float32 one step at a time; returns a's dtype."""
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                    device=a.device)
    out = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        out.append(h)
    return torch.stack(out, dim=1).to(a.dtype)


def rglru_ref(x: torch.Tensor, a: torch.Tensor, gate_x: torch.Tensor,
              gate_a: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
              c: float = 8.0) -> torch.Tensor:
    """The Real-Gated Linear Recurrent Unit, sequentially (the JAX
    package's oracle): x, gate_x, gate_a (B, T, D), a (D,);
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (sigmoid(gate_x_t) x_t) with
    a_t = exp(-c softplus(a) sigmoid(gate_a_t))."""
    a_t = torch.exp(-c * torch.nn.functional.softplus(a)[None]
                    * torch.sigmoid(gate_a))
    inp = torch.sqrt(torch.clamp(1.0 - torch.square(a_t), min=1e-12)) \
        * (torch.sigmoid(gate_x) * x)
    h = torch.zeros_like(x[:, 0]) if h0 is None else h0
    out = []
    for t in range(x.shape[1]):
        h = a_t[:, t] * h + inp[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def vita_msa_batched_ref(z: torch.Tensor, wq: torch.Tensor,
                         wk: torch.Tensor, wv: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         qkv_bias: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Float per-head MSA: z (B, N, D), w* (H, D, Dh) -> (B, H, N, Dh).
    Windowed mode: windows folded into the batch axis, ``bias`` (H, N, N)
    and ``mask`` (nW, N, N); ``qkv_bias`` (3, H, Dh) optional.  As the
    TPU kernel: float32 math on upcast inputs, P and V rounded to z's
    dtype before the AV product (`softmax_av`), the output cast to z's
    dtype (`PORTED_MODES`); in float32 this is the JAX oracle's math."""
    check_mode("vita_msa_batched", z, wq, wk, wv, qkv_bias)
    dh = wq.shape[2]
    zf = z.float()
    q, k, v = (torch.einsum("bnd,hde->bhne", zf, w.float())
               for w in (wq, wk, wv))
    q, k, v = _qkv_with_bias(q, k, v, qkv_bias)
    return softmax_av(q, k, v, scale=dh ** -0.5, bias=bias, mask=mask,
                      out_dtype=z.dtype).to(z.dtype)


def vita_msa_ref(z: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                 wv: torch.Tensor) -> torch.Tensor:
    """Single image: z (N, D) -> (H, N, Dh)."""
    return vita_msa_batched_ref(z[None], wq, wk, wv)[0]


def vita_msa_int8_ref(z_q, wq_q, wk_q, wv_q, x_scale, wq_scale, wk_scale,
                      wv_scale, bias=None, mask=None,
                      qkv_bias=None) -> torch.Tensor:
    """int8 per-head MSA: z_q (B, N, D) int8, w*_q (H, D, Dh) int8,
    x_scale scalar, w*_scale (H, Dh) -> (B, H, N, Dh) float32.  The
    optional float ``qkv_bias`` (3, H, Dh) joins after the requant;
    ``bias``/``mask`` select the windowed mode as in `softmax_av`."""
    h, d, dh = wq_q.shape
    xs = torch.as_tensor(x_scale, dtype=torch.float32,
                         device=z_q.device).reshape(())

    def proj(w_q, w_s):
        acc = int8_matmul_ref(z_q.unsqueeze(1), w_q.unsqueeze(0))  # (B,H,N,Dh)
        return acc.float() * (xs * w_s.float()[None, :, None, :])

    q, k, v = _qkv_with_bias(proj(wq_q, wq_scale), proj(wk_q, wk_scale),
                             proj(wv_q, wv_scale), qkv_bias)
    return softmax_av(q, k, v, scale=dh ** -0.5, bias=bias, mask=mask)


def _merge_qkv(wq, wk, wv) -> torch.Tensor:
    """(H, D, Dh) x3 -> one merged (D, 3*H*Dh) projection."""
    h, d, dh = wq.shape
    return torch.cat([w.permute(1, 0, 2).reshape(d, h * dh)
                      for w in (wq, wk, wv)], dim=1)


def _split_qkv(qkv: torch.Tensor, h: int, dh: int):
    """(B, N, 3*H*Dh) -> three (B, H, N, Dh)."""
    b, n, _ = qkv.shape
    parts = qkv.reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
    return parts[0], parts[1], parts[2]


def _attend_heads(q, k, v, dh: int, bias=None, mask=None) -> torch.Tensor:
    """(B, H, N, Dh) q/k/v -> (B, N, H*Dh) merged attention output."""
    sa = softmax_av(q, k, v, scale=dh ** -0.5, bias=bias, mask=mask)
    b, h, n, _ = sa.shape
    return sa.permute(0, 2, 1, 3).reshape(b, n, h * dh)


def _layer_f32(x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b, w_up,
               b_up, w_down, b_down, bias=None, mask=None, msa_axis=None,
               mlp_axis=None) -> torch.Tensor:
    """One float encoder layer in float32 math on upcast inputs; returns
    float32 (the TPU kernel's fp32 scratch, before its output cast).  With
    an axis the row-parallel partial is all-reduced before its residual,
    and ``b_down`` joins once, after the sum."""
    h, d, dh = wq.shape
    z = layer_norm_ref(x, ln1_w, ln1_b)
    qkv = torch.matmul(z, _merge_qkv(wq, wk, wv).float())
    q, k, v = _split_qkv(qkv, h, dh)
    merged = _attend_heads(q, k, v, dh, bias, mask)
    h1 = x.float() + psum(torch.matmul(merged, w_msa.float()), msa_axis)
    z2 = layer_norm_ref(h1, ln2_w, ln2_b)
    hid = gelu(torch.matmul(z2, w_up.float()) + b_up.float())
    if mlp_axis is not None:
        return h1 + psum(torch.matmul(hid, w_down.float()), mlp_axis) \
            + b_down.float()
    return h1 + (torch.matmul(hid, w_down.float()) + b_down.float())


def vita_layer_ref(x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b,
                   w_up, b_up, w_down, b_down, bias=None, mask=None, *,
                   msa_axis=None, mlp_axis=None):
    """Fused encoder layer: x (B, N, D) -> (B, N, D).

    LN1 -> merged-QKV -> per-head softmax.V [+ window bias/mask] ->
    concat projection -> residual -> LN2 -> GELU MLP -> residual, every
    intermediate in float32, the output cast once to x's dtype
    (`PORTED_MODES`).  On local shards ``msa_axis`` / ``mlp_axis`` all-
    reduce the concat and down partials (module docstring)."""
    check_mode("vita_layer", x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w,
               ln2_b, w_up, b_up, w_down, b_down)
    return _layer_f32(x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b, w_up,
                      b_up, w_down, b_down, bias, mask, msa_axis,
                      mlp_axis).to(x.dtype)


def vita_layer_int8_ref(x, wq_q, wk_q, wv_q, wmsa_q, wup_q, wdown_q,
                        act_scales, wq_scale, wk_scale, wv_scale,
                        wmsa_scale, wup_scale, wdown_scale, ln1_w, ln1_b,
                        ln2_w, ln2_b, b_up, b_down, bias=None, mask=None, *,
                        msa_axis=None, mlp_axis=None):
    """int8 fused encoder layer: every matmul input requantized at the
    frozen ``act_scales`` = [qkv_in, w_msa, w_up, w_down]; x float32 ->
    float32.  ``msa_axis`` / ``mlp_axis`` as in `vita_layer_ref`: the sum
    after the requant is exact because the contraction-side scales
    (wmsa_scale, wdown_scale) span the full output width and replicate."""
    b, n, d = x.shape
    h, _, dh = wq_q.shape
    m = wup_q.shape[1]
    s = act_scales.float().reshape(4)

    def requant_mm(v, sc, w_q, w_s, size):
        acc = int8_matmul_ref(quant(v, sc), w_q)
        return acc.float() * (sc * w_s.float().reshape(size))

    zq = quant(layer_norm_ref(x, ln1_w, ln1_b), s[0])
    scale_vec = torch.cat([ws.float().reshape(h * dh)
                           for ws in (wq_scale, wk_scale, wv_scale)])
    qkv = int8_matmul_ref(zq, _merge_qkv(wq_q, wk_q, wv_q)).float() \
        * (s[0] * scale_vec)
    q, k, v = _split_qkv(qkv, h, dh)
    merged = _attend_heads(q, k, v, dh, bias, mask)
    h1 = x.float() + psum(requant_mm(merged, s[1], wmsa_q, wmsa_scale, d),
                          msa_axis)
    z2 = layer_norm_ref(h1, ln2_w, ln2_b)
    hid = gelu(requant_mm(z2, s[2], wup_q, wup_scale, m) + b_up.float())
    down = psum(requant_mm(hid, s[3], wdown_q, wdown_scale, d), mlp_axis)
    return h1 + down + b_down.float()


def vita_layer_group_ref(x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b,
                         w_up, b_up, w_down, b_down, bias=None, mask=None, *,
                         msa_axis=None, mlp_axis=None):
    """Layer group: L stacked encoder layers one after the other, the
    activation carried in float32 between them and cast to x's dtype
    once at the end, as the TPU kernel carries it in its fp32 scratch (so
    in bf16 a group is not L bf16 layer calls).  Every weight operand
    carries the layer as its leading axis; ``bias`` is (L, H, n, n) and
    ``mask`` (nW, n, n) is shared by the members.  ``msa_axis`` /
    ``mlp_axis`` forward to every member (members share their specs)."""
    stacks = (wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b, w_up, b_up,
              w_down, b_down)
    check_mode("vita_layer_group", x, *stacks)
    y = x
    for l in range(wq.shape[0]):
        y = _layer_f32(y, *(t[l] for t in stacks),
                       None if bias is None else bias[l], mask, msa_axis,
                       mlp_axis)
    return y.to(x.dtype)


def vita_layer_group_int8_ref(x, wq_q, wk_q, wv_q, wmsa_q, wup_q, wdown_q,
                              act_scales, wq_scale, wk_scale, wv_scale,
                              wmsa_scale, wup_scale, wdown_scale, ln1_w,
                              ln1_b, ln2_w, ln2_b, b_up, b_down, bias=None,
                              mask=None, *, msa_axis=None, mlp_axis=None):
    """int8 layer group: `vita_layer_int8_ref` per member, each at its own
    frozen scales (``act_scales`` (L, 4), weight scales stacked on the
    layer axis); ``msa_axis`` / ``mlp_axis`` forward to every member."""
    y = x.float()
    for l in range(wq_q.shape[0]):
        y = vita_layer_int8_ref(
            y, wq_q[l], wk_q[l], wv_q[l], wmsa_q[l], wup_q[l], wdown_q[l],
            act_scales[l], wq_scale[l], wk_scale[l], wv_scale[l],
            wmsa_scale[l], wup_scale[l], wdown_scale[l], ln1_w[l], ln1_b[l],
            ln2_w[l], ln2_b[l], b_up[l], b_down[l],
            None if bias is None else bias[l], mask, msa_axis=msa_axis,
            mlp_axis=mlp_axis)
    return y

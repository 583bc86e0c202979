"""xLSTM mixers (counterpart of `repro/models/xlstm.py`): mLSTM (matrix
memory) and sLSTM (scalar memory), in plain torch, as the JAX package
runs them in plain jnp.

The signatures are the JAX package's (``cache_len``, ``dtype`` and
``pos`` are unused: the state's size and dtype are fixed).

mLSTM: exponential input / forget gating over a matrix memory C_t = f_t
C_{t-1} + i_t v_t k_t^T.  `mlstm_forward` uses the stabilised parallel
(attention-like) form; `mlstm_prefill` scans the recurrent form for the
exact end state, and `mlstm_decode` takes one recurrent step.  The
stabiliser m starts at -1e30, not -inf (with -inf, log_f + m - m_new is
NaN at the first step).

sLSTM: a scalar memory with a block-diagonal (per-head) hidden-to-hidden
recurrence, scanned over time step by step.

Random weights come from an explicit `torch.Generator`; a comparison with
the JAX package carries its weights over (`convert.lm_params_from_numpy`).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import act_fn
from .config import ModelConfig
from .layers import Params, dense_init, randn

M_INIT = -1e30
_silu = act_fn("silu")

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, head dim): d_inner is 2 x d_model (proj factor 2,
    xLSTM-1.3B)."""
    d_inner = 2 * cfg.d_model
    h = cfg.n_heads
    return d_inner, h, d_inner // h


def mlstm_init(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> Params:
    d = cfg.d_model
    d_inner, h, dh = _dims(cfg)
    dev = gen.device

    def blockdiag():
        # per-head (block-diagonal) projection, as in the xLSTM paper
        return torch.stack([dense_init(gen, dh, dh, dtype)
                            for _ in range(h)])

    return {
        "w_up": dense_init(gen, d, d_inner, dtype),
        "w_z": dense_init(gen, d, d_inner, dtype),      # output gate branch
        "w_q": blockdiag(),
        "w_k": blockdiag(),
        "w_v": blockdiag(),
        "w_if": dense_init(gen, d_inner, 2 * h, torch.float32),
        "b_if": torch.cat([torch.zeros((h,), device=dev),
                           torch.linspace(3.0, 6.0, h, device=dev)]),
        "gn_w": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "w_down": dense_init(gen, d_inner, d, dtype),
    }


def _mlstm_qkvif(p: Params, u: torch.Tensor, h: int):
    """u (B, T, Di) -> q, k, v (B, H, T, dh) in u's dtype, log_i / log_f
    (B, H, T) float32."""
    b, t, di = u.shape
    dh = di // h
    uh = u.reshape(b, t, h, dh)

    def proj(w):   # block-diagonal per-head projection
        return torch.einsum("bthd,hde->bhte", uh, w)

    q = proj(p["w_q"])
    k = proj(p["w_k"]) * (dh ** -0.5)
    v = proj(p["w_v"])
    gates = u.float() @ p["w_if"] + p["b_if"]               # (B, T, 2H)
    log_i = gates[..., :h].transpose(1, 2)                  # (B, H, T)
    log_f = F.logsigmoid(gates[..., h:]).transpose(1, 2)
    return q, k, v, log_i, log_f


def _mlstm_parallel(q, k, v, log_i, log_f):
    """Stabilised parallel mLSTM.  q, k, v: (B, H, T, dh); gates (B, H,
    T).  Returns h (B, H, T, dh) float32 and the stabiliser m (B, H, T)."""
    t = q.shape[2]
    fc = torch.cumsum(log_f, dim=-1)                        # inclusive
    # D_ts = fc_t - fc_s + log_i_s   (s <= t)
    dmat = fc[..., :, None] - fc[..., None, :] + log_i[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
    dmat = dmat.masked_fill(~mask, float("-inf"))
    m = dmat.amax(dim=-1)                                   # (B, H, T)
    w = torch.exp(dmat - m[..., None])                      # (B, H, T, T)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    cw = w * s
    numer = torch.einsum("bhts,bhsd->bhtd", cw, v.float())
    denom = torch.abs(cw.sum(-1))
    denom = torch.maximum(denom, torch.exp(-m))
    return numer / denom[..., None], m


def _mlstm_recurrent_step(state, q, k, v, log_i, log_f):
    """One step.  state: (C (B, H, dh, dh), n (B, H, dh), m (B, H)),
    float32; q, k, v: (B, H, dh); log_i / log_f: (B, H)."""
    c, n, m = state
    qf, kf, vf = q.float(), k.float(), v.float()
    m_new = torch.maximum(log_f + m, log_i)
    f_s = torch.exp(log_f + m - m_new)
    i_s = torch.exp(log_i - m_new)
    c = f_s[..., None, None] * c + i_s[..., None, None] * \
        torch.einsum("bhk,bhv->bhkv", kf, vf)
    n = f_s[..., None] * n + i_s[..., None] * kf
    h_num = torch.einsum("bhk,bhkv->bhv", qf, c)
    h_den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qf, n)),
                          torch.exp(-m_new))
    return (c, n, m_new), h_num / h_den[..., None]


def _headnorm(y: torch.Tensor, w: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """RMS-norm each head's dh slice.  y: (..., H, dh); w: (H*dh,).
    Returns (..., H*dh) in y's dtype."""
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    yn = y * torch.rsqrt(var + eps)
    return yn.reshape(*y.shape[:-2], -1) * (1.0 + w.to(y.dtype))


def _mlstm_out(p: Params, h_seq: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Head norm of h (..., H, dh), the SiLU output gate z, the down
    projection."""
    y = _headnorm(h_seq, p["gn_w"])
    y = (y * _silu(z.float())).to(dtype)
    return y @ p["w_down"]


def mlstm_forward(p: Params, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    _, h, _ = _dims(cfg)
    u = x @ p["w_up"]
    z = x @ p["w_z"]
    q, k, v, log_i, log_f = _mlstm_qkvif(p, u, h)
    h_attn, _ = _mlstm_parallel(q, k, v, log_i, log_f)      # (B, H, T, dh)
    return _mlstm_out(p, h_attn.transpose(1, 2), z, x.dtype)


def mlstm_init_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     dtype: torch.dtype, device=None
                     ) -> Dict[str, torch.Tensor]:
    """C (B, H, dh, dh), n (B, H, dh), m (B, H), float32, m at -1e30."""
    _, h, dh = _dims(cfg)
    f32 = torch.float32
    return {"C": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
            "m": torch.full((batch, h), M_INIT, dtype=f32, device=device)}


def mlstm_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  cache_len: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill by scanning the recurrent form (the exact end state)."""
    b, t, _ = x.shape
    _, h, _ = _dims(cfg)
    u = x @ p["w_up"]
    z = x @ p["w_z"]
    q, k, v, log_i, log_f = _mlstm_qkvif(p, u, h)
    c0 = mlstm_init_cache(cfg, b, cache_len, x.dtype, x.device)
    state = (c0["C"], c0["n"], c0["m"])
    hs = []
    for i in range(t):
        state, ht = _mlstm_recurrent_step(
            state, q[:, :, i], k[:, :, i], v[:, :, i], log_i[:, :, i],
            log_f[:, :, i])
        hs.append(ht)
    h_seq = torch.stack(hs, dim=1)                          # (B, T, H, dh)
    out = _mlstm_out(p, h_seq, z, x.dtype)
    return out, {"C": state[0], "n": state[1], "m": state[2]}


def mlstm_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 pos, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token, x (B, D); returns the output and a new cache."""
    _, h, _ = _dims(cfg)
    u = (x @ p["w_up"])[:, None]
    z = x @ p["w_z"]
    q, k, v, log_i, log_f = _mlstm_qkvif(p, u, h)
    state, ht = _mlstm_recurrent_step(
        (cache["C"], cache["n"], cache["m"]), q[:, :, 0], k[:, :, 0],
        v[:, :, 0], log_i[:, :, 0], log_f[:, :, 0])         # ht (B, H, dh)
    out = _mlstm_out(p, ht, z, x.dtype)
    return out, {"C": state[0], "n": state[1], "m": state[2]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    dev = gen.device
    b_in = torch.zeros((4 * d,), device=dev)
    b_in[d:2 * d] = 1.0                                     # f-gate bias
    return {
        # input projections for i, f, z, o stacked: (D, 4D)
        "w_in": dense_init(gen, d, 4 * d, dtype),
        "b_in": b_in,
        # block-diagonal (per-head) hidden-to-hidden recurrence
        "r": randn(gen, (4, h, dh, dh)) / math.sqrt(dh),
        "gn_w": torch.zeros((d,), dtype=dtype, device=dev),
    }


def _slstm_scan(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Tuple) -> Tuple[torch.Tensor, Tuple]:
    """x: (B, T, D); state (c, n, h, m), each (B, D) float32.  Returns
    the hidden states (B, T, D) float32 and the end state."""
    b, t, d = x.shape
    hh = cfg.n_heads
    dh = d // hh
    pre_all = (x @ p["w_in"]).float() + p["b_in"]           # (B, T, 4D)
    c, n, h, m = state
    hs = []
    for i in range(t):
        pre_t = pre_all[:, i]
        rec = torch.einsum("ghkl,bhk->gbhl", p["r"], h.reshape(b, hh, dh))
        rec = rec.reshape(4, b, d)
        zi = pre_t[:, 0 * d:1 * d] + rec[0]
        zf = pre_t[:, 1 * d:2 * d] + rec[1]
        zz = pre_t[:, 2 * d:3 * d] + rec[2]
        zo = pre_t[:, 3 * d:4 * d] + rec[3]
        log_i = zi
        log_f = F.logsigmoid(zf)
        m_new = torch.maximum(log_f + m, log_i)
        i_s = torch.exp(log_i - m_new)
        f_s = torch.exp(log_f + m - m_new)
        c = f_s * c + i_s * torch.tanh(zz)
        n = f_s * n + i_s
        h = torch.sigmoid(zo) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)


def _slstm_state(b: int, d: int, device) -> Tuple:
    zeros = lambda: torch.zeros((b, d), dtype=torch.float32, device=device)
    return (zeros(), zeros(), zeros(),
            torch.full((b, d), M_INIT, dtype=torch.float32, device=device))


def _slstm_out(p: Params, hs: torch.Tensor, cfg: ModelConfig,
               dtype: torch.dtype) -> torch.Tensor:
    b, t, d = hs.shape
    return _headnorm(hs.reshape(b, t, cfg.n_heads, d // cfg.n_heads),
                     p["gn_w"]).to(dtype)


def slstm_forward(p: Params, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    b, _, d = x.shape
    hs, _ = _slstm_scan(p, x, cfg, _slstm_state(b, d, x.device))
    return _slstm_out(p, hs, cfg, x.dtype)


def slstm_init_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     dtype: torch.dtype, device=None
                     ) -> Dict[str, torch.Tensor]:
    """c, n, h, m (B, D) float32, m at -1e30."""
    return dict(zip("cnhm", _slstm_state(batch, cfg.d_model, device)))


def slstm_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  cache_len: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, _, d = x.shape
    hs, state = _slstm_scan(p, x, cfg, _slstm_state(b, d, x.device))
    return _slstm_out(p, hs, cfg, x.dtype), dict(zip("cnhm", state))


def slstm_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 pos, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token, x (B, D); returns the output and a new cache."""
    state = tuple(cache[key] for key in "cnhm")
    hs, state = _slstm_scan(p, x[:, None], cfg, state)
    return _slstm_out(p, hs, cfg, x.dtype)[:, 0], dict(zip("cnhm", state))

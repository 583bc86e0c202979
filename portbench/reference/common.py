"""Plain PyTorch pieces shared by the reference forwards: the matrix
product at a stated precision, LayerNorm, the tanh GELU, softmax attention,
patch extraction and the seeded weight maker.

Nothing here imports the program.  Every product goes through `mm`, so one
switch sets the precision of the whole forward:

* ``"fp32"``: float32 products with TF32 off on the card
  (``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32``
  False), the precision the configurations state;
* ``"tf32"``: the control, one precision below.  On the card the same
  products with TF32 on; on a CPU, which has no TF32 unit, each operand is
  rounded to TF32's 10-bit mantissa (round to nearest even) before a
  float32 product, which is what the tensor cores do with it.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import torch

PRECISIONS = ("fp32", "tf32")
NEG_INF = -1e30


@contextlib.contextmanager
def precision(mode: str) -> Iterator[None]:
    """Set the card's TF32 switches for the duration; restore them after."""
    if mode not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {mode!r}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even),
    still stored as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``torch.matmul(a, b)`` in float32 at ``mode`` (module docstring);
    call it inside `precision(mode)`."""
    if mode == "tf32" and not a.is_cuda:
        a, b = round_tf32(a), round_tf32(b)
    return torch.matmul(a, b)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, population variance."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def attention(z: torch.Tensor, wq, wk, wv, mode: str, extra=None
              ) -> torch.Tensor:
    """Multi-head self-attention of z (B, N, D) with per-head weights
    (H, D, Dh): softmax(Q K^T / sqrt(Dh) [+ extra]) V, heads concatenated
    head-major -> (B, N, H*Dh).  ``extra`` is an additive (B, H, N, N)
    term, or anything that broadcasts to it."""
    bsz, n, _ = z.shape
    h, _, dh = wq.shape
    zh = z[:, None]                                      # (B, 1, N, D)
    q, k, v = (mm(zh, w[None], mode) for w in (wq, wk, wv))
    s = mm(q, k.transpose(-1, -2), mode) * (dh ** -0.5)
    if extra is not None:
        s = s + extra
    p = torch.softmax(s, dim=-1)
    o = mm(p, v, mode)                                   # (B, H, N, Dh)
    return o.permute(0, 2, 1, 3).reshape(bsz, n, h * dh)


def extract_patches(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, (H/P)*(W/P), P*P*3), each patch flattened in
    (row, column, channel) order, patches in raster order."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, (h // patch) * (w // patch), patch * patch * c)


# ---------------------------------------------------------------------------
# Seeded weights and images
# ---------------------------------------------------------------------------


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``seed``, so the
    weights and the images draw different streams."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


# How each kind of leaf is drawn from a standard normal r: a weight matrix
# r / sqrt(fan_in) (fan_in: the leaf's second-to-last axis), a LayerNorm
# scale 1 + 0.1 r, a LayerNorm shift or a bias 0.1 r, a table (positional
# embedding, relative-position bias) its own std times r.  LayerNorm
# vectors and biases are drawn, not set to 1 and 0, so that a path that
# ignores one changes the logits.
LEAF_KINDS = ("matrix", "ln_scale", "shift", "table")
ALIGN = 64      # elements: every leaf starts 256 bytes into the buffer


def make_tree(leaves: Sequence[Tuple[Tuple[Any, ...], Tuple[int, ...],
                                     str, float]],
              seed: int, device) -> Dict[str, Any]:
    """The nested tree of ``leaves`` ((path, shape, kind, std) each) drawn
    from ``seed`` on ``device``: one float32 buffer of standard normals
    from one generator on the device, each leaf a view into it, scaled in
    place by its kind.  A path is a tuple of dict keys and list indices."""
    device = torch.device(device)
    offsets, total = [], 0
    for _, shape, _, _ in leaves:
        offsets.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights"))
    buf = torch.randn(total, generator=gen, device=device,
                      dtype=torch.float32)
    tree: Dict[str, Any] = {}
    for (path, shape, kind, std), off in zip(leaves, offsets):
        leaf = buf[off:off + math.prod(shape)].view(shape)
        if kind == "matrix":
            leaf.mul_(1.0 / math.sqrt(shape[-2]))
        elif kind == "ln_scale":
            leaf.mul_(0.1).add_(1.0)
        elif kind in ("shift", "table"):
            leaf.mul_(std)
        else:
            raise ValueError(f"unknown leaf kind {kind!r}")
        _put(tree, path, leaf)
    return tree


def _put(tree: Any, path: Tuple[Any, ...], leaf: torch.Tensor) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
        node[path[-1]] = leaf
    else:
        node[path[-1]] = leaf


def block_leaves(prefix: Tuple[Any, ...], dim: int, heads: int, hidden: int
                 ) -> List[Tuple[Tuple[Any, ...], Tuple[int, ...], str,
                                 float]]:
    """One encoder block's leaves in the program's layout: per-head
    wq/wk/wv (H, D, Dh), w_msa (H*Dh, D), the MLP, two LayerNorms."""
    dh = dim // heads
    return [
        (prefix + ("ln1_w",), (dim,), "ln_scale", 0.0),
        (prefix + ("ln1_b",), (dim,), "shift", 0.1),
        (prefix + ("wq",), (heads, dim, dh), "matrix", 0.0),
        (prefix + ("wk",), (heads, dim, dh), "matrix", 0.0),
        (prefix + ("wv",), (heads, dim, dh), "matrix", 0.0),
        (prefix + ("w_msa",), (heads * dh, dim), "matrix", 0.0),
        (prefix + ("ln2_w",), (dim,), "ln_scale", 0.0),
        (prefix + ("ln2_b",), (dim,), "shift", 0.1),
        (prefix + ("w_up",), (dim, hidden), "matrix", 0.0),
        (prefix + ("b_up",), (hidden,), "shift", 0.1),
        (prefix + ("w_down",), (hidden, dim), "matrix", 0.0),
        (prefix + ("b_down",), (dim,), "shift", 0.1),
    ]


def images(seed: int, n: int, side: int, device) -> torch.Tensor:
    """``n`` standard-normal (side, side, 3) float32 images from ``seed``,
    made on ``device``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(derive(seed, "images"))
    return torch.randn((n, side, side, 3), generator=gen,
                       device=torch.device(device), dtype=torch.float32)

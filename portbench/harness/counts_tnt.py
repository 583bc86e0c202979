"""The operations a TNT image needs, as the program computes it (the
configuration's ``flops_per_image``), beside `harness.counts`, which
counts the other families.

Per image of N patches, each of m pixel tokens of width c:

* the pixel embedding: N m sub-patches of ip * ip * 3 pixels to c;
* the patch embedding: N patches of m c to D;
* per layer, the inner block over N sequences of m tokens (Q/K/V, Q K^T,
  P V, the output projection, the MLP), the fold (m c to D over N
  patches) and the outer block over one sequence of N tokens.

LayerNorms, GELU, softmax, the positional embeddings, the mean pool and
the head (D x classes) are left out, as `harness.counts` leaves them out.

The program's `core/perfmodel.py::count_macs` counts every block and the
fold as this module does, but prices the embedding as ViT's, N patches of
P * P * 3 to D; the program computes it through the pixel tokens, which
is this module's two embedding terms.
"""

from __future__ import annotations

from typing import Any, Mapping

from harness.counts import _stage_macs


def embed_macs(s: Mapping[str, Any]) -> int:
    """The pixel and the patch embedding's MACs an image."""
    n = (s["image"] // s["patch"]) ** 2
    m = (s["patch"] // s["inner_patch"]) ** 2
    c, ip = s["inner_dim"], s["inner_patch"]
    return n * m * (ip * ip * 3) * c + n * (m * c) * s["dim"]


def layer_macs(s: Mapping[str, Any]) -> int:
    """One layer's MACs an image: the inner block, the fold, the outer
    block."""
    n = (s["image"] // s["patch"]) ** 2
    m = (s["patch"] // s["inner_patch"]) ** 2
    c, d = s["inner_dim"], s["dim"]
    inner = _stage_macs(m, n, c, s["inner_heads"], s["inner_mlp_ratio"], 1)
    fold = n * (m * c) * d
    outer = _stage_macs(n, 1, d, s["heads"], s["mlp_ratio"], 1)
    return inner + fold + outer


def macs_per_image(s: Mapping[str, Any]) -> int:
    return embed_macs(s) + s["layers"] * layer_macs(s)


def flops_per_image(s: Mapping[str, Any]) -> int:
    return 2 * macs_per_image(s)

"""Vision head masks (counterpart of the vision part of
`repro/models/config.py`)."""

from __future__ import annotations


def normalize_head_mask(mask, *, layers: int, heads: int):
    """Canonicalize ``mask`` to a ``layers x heads`` tuple of 0/1 tuples.

    Accepts ``None`` (dense — returned unchanged), one flat per-head mask
    of length ``heads`` (broadcast to every layer), or a per-layer
    sequence of per-head masks.  Every layer must keep at least one head;
    lengths must match exactly (a mask outliving a config change is a
    deployment bug, not a broadcast opportunity).
    """
    if mask is None:
        return None
    rows = list(mask)
    if rows and not hasattr(rows[0], "__len__"):
        rows = [rows] * layers                       # flat mask: all layers
    if len(rows) != layers:
        raise ValueError(
            f"head mask has {len(rows)} layer rows, config has {layers}")
    out = []
    for li, row in enumerate(rows):
        row = tuple(int(bool(v)) for v in row)
        if len(row) != heads:
            raise ValueError(
                f"head mask layer {li} has {len(row)} entries, config "
                f"has {heads} heads")
        if not any(row):
            raise ValueError(f"head mask layer {li} keeps no heads")
        out.append(row)
    return tuple(out)


def surviving_heads(mask_row) -> tuple:
    """Indices of the heads a per-layer mask row keeps, in order."""
    return tuple(i for i, v in enumerate(mask_row) if v)

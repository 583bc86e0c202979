"""What the benchmark may load: no JAX, no JAX package.

Module names are compared by their top-level name (the part before the
first dot) as a whole word: ``repro_torch`` is the program, ``repro`` the
JAX package it is ported from.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
# The reference may not import the program either.
FORBIDDEN_IN_REFERENCE = FORBIDDEN | {"repro_torch"}


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules: Iterable[str]) -> List[str]:
    """The names among ``modules`` (e.g. ``sys.modules``) whose top-level
    name is forbidden."""
    return sorted(m for m in modules if top_level(m) in FORBIDDEN)


def imports_of(path: Path) -> List[str]:
    """Every module a Python file imports, by its AST (relative imports
    are left out: they stay inside the file's package)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out: List[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            out.append(node.module)
    return out


def reference_violations(ref_dir: Path) -> List[str]:
    """``file: module`` for each forbidden import under ``ref_dir``."""
    bad = []
    for f in sorted(Path(ref_dir).rglob("*.py")):
        bad += [f"{f.name}: {m}" for m in imports_of(f)
                if top_level(m) in FORBIDDEN_IN_REFERENCE]
    return bad

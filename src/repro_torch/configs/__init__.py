"""Architecture configs (one module per architecture) and the registry
(counterpart of `repro/configs`)."""

from .registry import SHAPES, cell_supported, get, list_archs

__all__ = ["get", "list_archs", "SHAPES", "cell_supported"]

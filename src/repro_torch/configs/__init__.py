"""Architecture configs (one module per architecture) and the registry
(counterpart of `repro/configs`)."""

from .registry import (SHAPES, all_cells, cell_supported, decode_inputs, get,
                       input_specs, list_archs, prefill_inputs, train_inputs)

__all__ = ["get", "list_archs", "SHAPES", "cell_supported", "all_cells",
           "train_inputs", "prefill_inputs", "decode_inputs", "input_specs"]

"""Assigned architecture configs (exact figures, copied from the JAX
package) and the input-shape registry.

``get_config(arch_id)`` returns the full :class:`ModelConfig`;
``input_specs(arch, shape)`` returns the shape and dtype of every model
input of a cell (``InputSpec``), which the dry-run turns into fake
tensors.
"""

from repro_torch.configs.registry import (ALL_ARCHS, ARCHS, CELLS,
                                          PORT_ONLY_ARCHS, SHAPES,
                                          cell_skip_reason, get_config,
                                          input_specs, list_cells)

__all__ = ["ALL_ARCHS", "ARCHS", "PORT_ONLY_ARCHS", "SHAPES", "CELLS",
           "cell_skip_reason", "get_config", "input_specs", "list_cells"]

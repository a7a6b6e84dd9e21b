"""Assigned architecture configs (exact figures, copied from the JAX
package); ``get_config(arch_id)`` returns the full :class:`ModelConfig`."""

from repro_torch.configs.registry import ARCHS, get_config

__all__ = ["ARCHS", "get_config"]

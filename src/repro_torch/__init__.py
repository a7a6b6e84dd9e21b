"""PyTorch/CUDA port of the energy-aware DVFS scheduler.

Mirrors the tree of the JAX package ``repro`` (``core/``, ``kernels/``)
and imports nothing of it; ``convert`` carries state across from it.
Importing this package imports no submodule.
"""

"""Hand-written CUDA kernels for Hopper, with their plain torch versions.

* ``dvfs_opt`` — the batched single-task DVFS optimum (Algorithm 1's
  per-task solve), ``csrc/dvfs_opt.cu``;
* ``build``    — compiles ``csrc/*.cu`` with ``nvcc`` at first use;
* ``ops``      — the public wrappers and the ``device=`` policy;
* ``ref``      — the grid+golden oracle the kernel is held against.

Importing the package imports none of them, so the solver modules can
import these lazily without a cycle.
"""

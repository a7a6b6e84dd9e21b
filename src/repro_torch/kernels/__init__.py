"""Hand-written CUDA kernels for Hopper, with their plain torch versions.

* ``dvfs_opt``        — the batched single-task DVFS optimum (Algorithm 1's
  per-task solve), ``csrc/dvfs_opt.cu``;
* ``flash_attention`` — forward GQA attention, causal and/or windowed, with
  a bidirectional prefix (every attention prefill: dense, moe, hybrid,
  encdec, vlm), ``csrc/flash_attention.cu``, and its gradient (training),
  ``csrc/flash_attention_bwd.cu``;
* ``ssd_scan``        — the Mamba2 SSD chunked scan (ssm-family prefill),
  ``csrc/ssd_scan.cu``;
* ``build``           — compiles ``csrc/*.cu`` with ``nvcc`` at first use;
* ``ops``             — the public wrappers and the ``device=`` policy;
* ``ref``             — the oracles the kernels are held against.

Importing the package imports none of them, so the solver modules can
import these lazily without a cycle.
"""

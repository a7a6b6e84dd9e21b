"""Hand-written CUDA kernels for Hopper, with their plain torch versions.

* ``dvfs_opt``        — the batched single-task DVFS optimum (Algorithm 1's
  per-task solve), ``csrc/dvfs_opt.cu``;
* ``flash_attention`` — forward GQA attention, causal and/or windowed, with
  a bidirectional prefix (every attention prefill: dense, moe, hybrid,
  encdec, vlm), ``csrc/flash_attention.cu``, and its gradient (training),
  ``csrc/flash_attention_bwd.cu``;
* ``ssd_scan``        — the Mamba2 SSD chunked scan (ssm-family prefill),
  ``csrc/ssd_scan.cu``;
* ``adamw``           — AdamW's update and its per-leaf gradient norms over
  every leaf in one table (training), ``csrc/adamw.cu``;
* ``causal_conv``     — Mamba-2's depthwise causal conv with its bias and
  SiLU, forward and backward (ssm-family prefill and training),
  ``csrc/causal_conv.cu``;
* ``build``           — compiles ``csrc/*.cu`` with ``nvcc`` at first use;
* ``ops``             — the public wrappers and the ``device=`` policy;
* ``ref``             — the oracles the kernels are held against.

Importing the package imports none of them, so the solver modules can
import these lazily without a cycle.

The model kernels are ``torch.library`` custom operators (namespace
``repro_torch``) with fake implementations and FLOP formulas, so a
``FakeTensorMode`` trace and ``FlopCounterMode`` see them; AdamW's two
and the causal conv's two are operators with fake implementations too
(element-wise work: no FLOP formula).

Kernels take plain local tensors: a ``DTensor`` (a sharded weight of
``repro_torch.partition``) that reaches a kernel wrapper raises instead of
running the plain version's torch ops on it; gather it first
(``partition.wcast``).
"""

from repro_torch.partition import is_dtensor

#: Device types whose tensors the model kernels' wrappers hand to their
#: custom operators: the card's, where the operators launch the kernels,
#: and ``meta``, where only the operators' fake implementations run (the
#: dry-run traces on ``meta`` where torch is built without CUDA).
OP_DEVICES = ("cuda", "meta")


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise ``TypeError`` if any of ``tensors`` is a ``DTensor``."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{name} takes local tensors, got a DTensor: gather "
                        "it first (repro_torch.partition.wcast)")

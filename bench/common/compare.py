"""The numbers that decide ``correct``, each against its limit
(``bench/limits/<workload>.json``).

Training (readings of the first three steps, the program's and the
reference's alike: ``{"loss": [3], "grad": [leaves], "change": [leaves]}``):

* ``loss_rel``: the largest |program - reference| / |reference| of the three
  steps' losses, and ``loss1_rel`` the first step's alone (a cell's limits
  file names which of them it compares);
* ``grad_gap``: the worst leaf's |program - reference| norm of the clipped
  first gradient, over the reference's norm of that leaf or of the median
  leaf, whichever is larger;
* ``change_gap``: the same of each leaf's change over the three steps,
  leaving out the leaves whose reference gradient is under
  ``ROUNDOFF_LEAF`` of the median leaf's (AdamW moves them by round-off
  alone).

Serving: ``logit_gap``, the widest gap by which a served token's logit lies
below the reference's best at the position that produced it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

ROUNDOFF_LEAF = 1e-3


def worst_leaf(got: torch.Tensor, want: torch.Tensor, keep=None
               ) -> Tuple[float, int]:
    """(worst gap, its leaf index) of per-leaf norms: |got - want| over
    max(want, the median of want), among the leaves ``keep``."""
    if keep is None:
        keep = torch.ones_like(want, dtype=torch.bool)
    idx = torch.nonzero(keep)[:, 0]
    g, w = got[idx].double(), want[idx].double()
    gap = (g - w).abs() / torch.clamp(w, min=float(w.median()))
    i = int(torch.argmax(gap))
    return float(gap[i]), int(idx[i])


def train_numbers(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, float], Dict[str, int]]:
    """({name: value}, {name: worst leaf index}) of the three numbers."""
    steps = ((prog["loss"].double() - ref["loss"].double()).abs()
             / ref["loss"].double().abs())
    grad, gi = worst_leaf(prog["grad"], ref["grad"])
    keep = ref["grad"] >= ROUNDOFF_LEAF * ref["grad"].median()
    change, ci = worst_leaf(prog["change"], ref["change"], keep)
    return ({"loss_rel": float(steps.max()), "loss1_rel": float(steps[0]),
             "grad_gap": grad, "change_gap": change},
            {"grad_gap": gi, "change_gap": ci})


def logit_gaps(logits: List[torch.Tensor], tokens: List[List[int]]
               ) -> List[float]:
    """Each row's widest gap: logits [n, vocab] at the positions that
    produced ``tokens`` [n]."""
    out = []
    for lg, tok in zip(logits, tokens):
        t = torch.as_tensor(tok, device=lg.device)
        picked = lg.gather(1, t[:, None])[:, 0]
        out.append(float((lg.max(dim=1).values - picked).max()))
    return out


def first_choice_gaps(ref: List[torch.Tensor], other: List[torch.Tensor]
                      ) -> List[float]:
    """Each row's widest gap, by the reference's logits, of the token that
    ``other`` puts first (a control read without decoding)."""
    return logit_gaps(ref, [o.argmax(dim=1).tolist() for o in other])


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """``{name: {"value", "limit"}}`` for every limit (the numbers a cell
    compares); a number the run did not read counts as infinite."""
    return {k: {"value": values.get(k, float("inf")), "limit": lim}
            for k, lim in limits.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())

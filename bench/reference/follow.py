"""The reference's side of each comparison: it rebuilds the inputs from the
seed (weights, rows, padded prompts) and follows what the program did.

* Training: the first ``steps`` steps of the cell's job, float32 (or the
  control's rendering), with the cell's AdamW: each step's loss, the
  clipped first gradient's norm a leaf, and each leaf's change after the
  last step.
* Serving: one forward pass over each sampled request's padded prompt and
  served tokens, the logits at the positions that produced them.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from bench.common import traffic, weights
from bench.reference.common import (AdamWSpec, Prec, adamw_step,
                                    cross_entropy, float32_highest)


def family(name: str):
    """The reference module of a model family (``bench/reference/<name>.py``)."""
    return importlib.import_module(f"bench.reference.{name}")


def train_readings(fam_name: str, m: dict, mix: dict, seed: int, device,
                   prec: Prec, steps: int) -> Dict[str, torch.Tensor]:
    """``{"loss": [steps], "grad": [leaves], "change": [leaves]}`` float32 on
    the host: the first step's clipped gradient norm a leaf, and each
    leaf's change after ``steps`` steps."""
    float32_highest()
    fam = family(fam_name)
    specs = fam.param_specs(m)
    paths = [p for p, _, _ in specs]
    _, start = weights.make(specs, seed, device)
    _, leaves = weights.make(specs, seed, device)
    live = [t.detach().requires_grad_() for t in leaves]
    mom = [torch.zeros_like(t) for t in live]
    var = [torch.zeros_like(t) for t in live]
    spec = AdamWSpec.of(mix)
    losses, grad = [], None
    for step in range(steps):
        batch = traffic.train_batch(mix, m["vocab_size"], seed, step, device)
        P = weights.tree_of(paths, live)
        x = fam.hidden(P, batch["tokens"], m, prec, train=True)
        loss = cross_entropy(x.reshape(-1, x.shape[-1]), fam.head(P, m),
                             batch["labels"].reshape(-1), prec)
        grads = torch.autograd.grad(loss, live)
        del x, P
        norms = adamw_step(spec, live, list(grads), mom, var, step + 1)
        del grads
        losses.append(loss.detach())
        if step == 0:
            grad = norms
    with torch.no_grad():
        change = torch.stack([torch.linalg.vector_norm(p - q)
                              for p, q in zip(live, start)])
    return {"loss": torch.stack(losses).float().cpu(),
            "grad": grad.float().cpu(), "change": change.float().cpu()}


@torch.no_grad()
def serve_logits(fam_name: str, m: dict, seed: int, device,
                 rows: List[torch.Tensor], positions: List[List[int]],
                 precs: List[Prec]) -> List[List[torch.Tensor]]:
    """For each precision, each row's logits [len(positions[i]), vocab] at
    its positions: rows are whole token sequences (the padded prompt and
    the served tokens but the last)."""
    float32_highest()
    fam = family(fam_name)
    specs = fam.param_specs(m)
    P, _ = weights.make(specs, seed, device)
    out = []
    for prec in precs:
        per = []
        for row, pos in zip(rows, positions):
            x = fam.hidden(P, row.to(device)[None], m, prec)[0, pos]
            per.append(prec.mm(x, fam.head(P, m)).float())
        out.append(per)
    return out

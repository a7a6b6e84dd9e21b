"""Driver of a training cell: ``make_train_step(model, AdamW)`` of the port on
the benchmark's weights and rows, a closed loop of steps (the next starts
when the last has synchronized).

Set-up builds the one training state, runs its first ``CHECK_STEPS`` steps
through the window's own call and feed (steps 0-2 of the mix's rows) and
reads them for the comparison: each step's loss, the clipped first
gradient's norm a leaf as AdamW holds it (its first moment after one step
over ``1 - b1``), and each leaf's change after the three (against the
weights rebuilt from the seed).  The window then continues the same state
from step 3 for ``--seconds``.  After the window the state is freed and the
reference follows the same three steps.
"""

from __future__ import annotations

import time

import torch

from bench.common import compare, trace, traffic, weights
from bench.common.cell import (CHECK_STEPS, TRACE_STEPS, Cell, free,
                               memory_peak, sync)
from bench.reference import follow
from bench.reference.common import FP32


def build(cell: Cell):
    """(state, step function, leaf paths, b1) of the port on the cell's
    weights."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import TrainState, make_train_step

    o = cell.mix["optimizer"]
    model = Model(ModelConfig(**cell.model), device=cell.device)
    opt = AdamW(learning_rate=cosine_schedule(o["lr"], o["warmup"],
                                              o["total"]),
                b1=o["b1"], b2=o["b2"], eps=o["eps"],
                weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])
    specs = follow.family(cell.family).param_specs(cell.model)
    params, _ = weights.make(specs, cell.seed, cell.device)
    state = TrainState(params=params, opt=opt.init(params),
                       step=torch.zeros((), dtype=torch.int32,
                                        device=cell.device))
    return state, make_train_step(model, opt), [p for p, _, _ in specs], \
        o["b1"]


def program_readings(cell: Cell, state, step, paths, b1):
    """Run the first ``CHECK_STEPS`` steps; (state, their readings)."""
    vocab = cell.model["vocab_size"]
    losses, grad = [], None
    for i in range(CHECK_STEPS):
        batch = traffic.train_batch(cell.mix, vocab, cell.seed, i, cell.device)
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].detach().float())
        if i == 0:
            grad = weights.leaf_norms(state.opt.m, paths) / (1 - b1)
    specs = follow.family(cell.family).param_specs(cell.model)
    _, start = weights.make(specs, cell.seed, cell.device)
    change = weights.leaf_norms(state.params, paths, minus=start)
    del start
    return state, {"loss": torch.stack(losses).cpu(), "grad": grad.cpu(),
                   "change": change.cpu()}


def run(cell: Cell) -> dict:
    dev, mix = cell.device, cell.mix
    vocab = cell.model["vocab_size"]
    tokens_a_step = int(mix["batch"]) * int(mix["seq"])
    state, step, paths, b1 = build(cell)
    cell.mark("built")
    state, prog = program_readings(cell, state, step, paths, b1)
    cell.mark("check_steps")
    free(dev)
    sync(dev)
    if dev.type == "cuda":   # the window's peak, not the comparison's copy
        torch.cuda.reset_peak_memory_stats(dev)

    box = {"state": state, "i": CHECK_STEPS}
    del state

    def one(_=None):
        batch = traffic.train_batch(mix, vocab, cell.seed, box["i"], dev)
        box["state"], metrics = step(box["state"], batch)
        box["i"] += 1
        return metrics["loss"]

    window_start = time.time()
    cell.meter.start()
    t0 = time.perf_counter()
    losses = []
    while True:
        losses.append(one())
        sync(dev)
        if time.perf_counter() - t0 >= cell.seconds:
            break
    window_s = time.perf_counter() - t0
    energy_j = cell.meter.stop()
    steps = len(losses)
    traced = None
    if cell.trace:
        def traced_step(_):
            losses.append(one())
            sync(dev)

        traced = trace.traced(traced_step, TRACE_STEPS)
        traced["steps"] = TRACE_STEPS
    finite = bool(torch.isfinite(torch.stack(losses)).all())
    peak = memory_peak(dev)
    box.clear()
    free(dev)

    t_ref = time.perf_counter()
    ref = follow.train_readings(cell.family, cell.model, mix, cell.seed, dev,
                                FP32, CHECK_STEPS)
    reference_s = time.perf_counter() - t_ref
    values, worst = compare.train_numbers(prog, ref)
    return {"kind": "train", "family": cell.family, "model": cell.model,
            "mix": mix, "window_start": window_start, "window_s": window_s,
            "energy_j": energy_j, "steps": steps,
            "tokens": steps * tokens_a_step,
            "attempted": steps, "failed": 0 if finite else steps,
            "memory_peak_bytes": peak, "trace": traced,
            "checks": compare.judge(values, cell.limits),
            "readings": values,
            "notes": {"reference_s": reference_s, "readings": values,
                      "worst_leaf": {k: "/".join(map(str, paths[i]))
                                     for k, i in worst.items()},
                      "program": {k: v.tolist() for k, v in prog.items()
                                  if k == "loss"},
                      "reference": {"loss": ref["loss"].tolist()}}}

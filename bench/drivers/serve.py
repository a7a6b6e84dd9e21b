"""Driver of a serving cell: the port's ``Server.run`` on batches of the mix's
requests, back to back (a closed loop: a batch starts when the last has
returned).

A request's time to first token is its batch's ``prefill_s``: host seconds
from the batch's submission to its first greedy tokens on the host side of
a synchronize (``Server.run`` left-pads the batch to its longest prompt and
prefills it whole).  Set-up serves one round of the pool's batch shapes, so
that every shape the window uses has run once.

After the window a sample of its requests, drawn from the seed and always
holding one of the longest batch's, goes to the reference: one float32
forward pass over each request's padded prompt (the pads are token 0 at
positions 0.., unmasked, as ``Server.run`` feeds them) and its served
tokens but the last, read at the positions that produced the served tokens.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench.common import compare, trace, traffic, weights
from bench.common.cell import TRACE_BATCHES, Cell, free, memory_peak, sync
from bench.reference import follow
from bench.reference.common import FP32

#: Stream of the sample of requests checked.
SAMPLE_STREAM = 2


def build(cell: Cell):
    """The port's ``Server`` on the cell's weights."""
    from repro_torch.launch.serve import Server
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model

    mix = cell.mix
    model = Model(ModelConfig(**cell.model), device=cell.device)
    params, _ = weights.make(follow.family(cell.family).param_specs(
        cell.model), cell.seed, cell.device)
    return Server(model, params, batch_slots=int(mix["batch"]),
                  max_seq=int(mix["max"]) + int(mix["new_tokens"]),
                  device=cell.device)


def serve(srv, batches, new_tokens: int) -> dict:
    """One ``Server.run`` of the next batch of ``batches``."""
    from repro_torch.launch.serve import Request
    j, prompts = next(batches)
    reqs = [Request(rid=i, prompt=p, max_new=new_tokens)
            for i, p in enumerate(prompts)]
    stats = srv.run(reqs)
    return {"pool": j, "s0": max(len(p) for p in prompts),
            "lengths": [len(p) for p in prompts], "requests": reqs, **stats}


def sample(done: list, count: int, seed: int) -> list:
    """(batch, request) pairs to check: one of the longest batch's requests
    and ``count - 1`` others, drawn from the seed."""
    rng = np.random.default_rng(weights.stream_seed(seed, SAMPLE_STREAM))
    pairs = [(b, r) for b in done for r in b["requests"]]
    longest = max(b["s0"] for b in done)
    first = [i for i, (b, _) in enumerate(pairs) if b["s0"] == longest]
    pick = [int(rng.choice(first))]
    rest = [i for i in range(len(pairs)) if i != pick[0]]
    pick += [int(i) for i in rng.choice(rest, size=min(count - 1, len(rest)),
                                        replace=False)]
    return [pairs[i] for i in pick]


def rows_of(picked: list):
    """Each picked request's token row (pads, prompt, served tokens but the
    last), the positions whose logits chose its served tokens, and the
    tokens."""
    rows, positions, tokens = [], [], []
    for b, r in picked:
        s0, n = b["s0"], len(r.out)
        if not n:   # never served: counted as failed
            continue
        pad = np.zeros(s0 - len(r.prompt), np.int64)
        rows.append(torch.from_numpy(np.concatenate(
            [pad, r.prompt.astype(np.int64), np.asarray(r.out[:-1],
                                                         np.int64)])))
        positions.append(list(range(s0 - 1, s0 - 1 + n)))
        tokens.append(list(r.out))
    return rows, positions, tokens


def run(cell: Cell) -> dict:
    dev, mix = cell.device, cell.mix
    new = int(mix["new_tokens"])
    srv = build(cell)
    cell.mark("built")
    free(dev)
    batches = traffic.serve_batches(mix, cell.model["vocab_size"], cell.seed)
    for _ in range(int(mix["pool"])):
        serve(srv, batches, new)
    sync(dev)
    cell.mark("warm_batches")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    window_start = time.time()
    cell.meter.start()
    t0 = time.perf_counter()
    done = []
    while True:
        done.append(serve(srv, batches, new))
        if time.perf_counter() - t0 >= cell.seconds:
            break
    window_s = time.perf_counter() - t0
    energy_j = cell.meter.stop()
    traced = None
    if cell.trace:
        extra = []
        traced = trace.traced(lambda i: extra.append(serve(srv, batches, new)),
                              TRACE_BATCHES)
        traced["batches"] = [{"s0": b["s0"], "lengths": b["lengths"]}
                             for b in extra]
    peak = memory_peak(dev)
    del srv
    free(dev)

    requests = [r for b in done for r in b["requests"]]
    failed = sum(1 for b in done for r in b["requests"]
                 if len(r.out) != r.max_new or not b["logits_finite"])
    picked = sample(done, int(mix["check_requests"]), cell.seed)
    rows, positions, tokens = rows_of(picked)
    t_ref = time.perf_counter()
    ref = follow.serve_logits(cell.family, cell.model, cell.seed, dev, rows,
                              positions, [FP32])[0]
    reference_s = time.perf_counter() - t_ref
    gaps = compare.logit_gaps(ref, tokens)
    return {"kind": "serve", "family": cell.family, "model": cell.model,
            "mix": mix, "window_start": window_start, "window_s": window_s,
            "energy_j": energy_j,
            "batches": [{k: b[k] for k in ("pool", "s0", "lengths",
                                           "prefill_s", "decode_s",
                                           "new_tokens")} for b in done],
            "ttft_s": [b["prefill_s"] for b in done for _ in b["requests"]],
            "tokens": sum(b["new_tokens"] for b in done),
            "attempted": len(requests), "failed": failed,
            "memory_peak_bytes": peak, "trace": traced,
            "checks": compare.judge({"logit_gap": max(gaps, default=float(
                "inf"))}, cell.limits),
            "notes": {"reference_s": reference_s,
                      "checked_requests": len(picked),
                      "checked_tokens": sum(len(t) for t in tokens),
                      "gaps": gaps}}

"""The one generator of the benchmark's traffic: it reads a mix's parameters
(``bench/traffic/<mix>.json``) and makes the inputs of a run from its seed.

Training mixes (``"kind": "train"``) give ``batch``, ``seq`` and a Zipf law
over the vocabulary; each step's rows are drawn on the device from the seed
and the step's index, so a replay of a step gets the same rows and no two
steps share a generator.

Serving mixes (``"kind": "serve"``) give a log-normal law of prompt lengths
(``median``, ``sigma``, clipped to ``[min, max]``), ``new_tokens`` a request,
``batch`` requests a ``Server.run`` and ``pool`` batch shapes.  The lengths
are fixed by the mix, not drawn: batch j of the pool holds, for each of the
``batch`` equal strata of the law, the quantile ``(i + (j + 1/2) / pool) /
batch`` of stratum i, so the pool is ``pool * batch`` evenly spaced
quantiles and every batch spans the whole law.  The window serves the pool's
batches in turn, round after round; the seed permutes the
requests inside each batch and draws their tokens.  Every seed thus runs the
same set of batch shapes in the same order, which keeps the seed from
changing the work a window holds.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np
import torch

from bench.common.weights import generator, stream_seed

#: Stream of a step's training rows: DATA_STREAM + step.
DATA_STREAM = 1 << 20
#: Stream of the serving prompts.
PROMPT_STREAM = 1


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    if mix.get("kind") not in ("train", "serve"):
        raise ValueError(f"{path}: kind must be 'train' or 'serve'")
    return mix


def zipf_cdf(vocab: int, exponent: float) -> np.ndarray:
    """Cumulative probabilities [vocab] of token id k with weight
    ``(k + 1) ** -exponent``, in float64."""
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -float(exponent)
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def train_rows(mix: dict, vocab: int, seed: int, step: int, device
               ) -> torch.Tensor:
    """The ``[batch, seq + 1]`` token ids of training step ``step`` (0-based),
    on ``device``."""
    B, S = int(mix["batch"]), int(mix["seq"])
    cdf = torch.as_tensor(zipf_cdf(vocab, mix["zipf_exponent"]),
                          device=device)
    u = torch.rand(B * (S + 1), generator=generator(seed, DATA_STREAM + step,
                                                     device),
                   dtype=torch.float64, device=device)
    ids = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
    return ids.view(B, S + 1)


def train_batch(mix: dict, vocab: int, seed: int, step: int, device) -> dict:
    """``{"tokens", "labels"}`` [batch, seq] of step ``step``: the labels are
    the next tokens."""
    rows = train_rows(mix, vocab, seed, step, device)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def prompt_lengths(mix: dict) -> List[List[int]]:
    """The pool: ``pool`` batches of ``batch`` prompt lengths each."""
    law = statistics.NormalDist()
    n, pool = int(mix["batch"]), int(mix["pool"])
    mu, sigma = math.log(mix["median"]), float(mix["sigma"])
    out = []
    for j in range(pool):
        lengths = []
        for i in range(n):
            z = law.inv_cdf((i + (j + 0.5) / pool) / n)
            length = round(math.exp(mu + sigma * z))
            lengths.append(int(min(max(length, mix["min"]), mix["max"])))
        out.append(lengths)
    return out


def serve_batches(mix: dict, vocab: int, seed: int
                  ) -> Iterator[Tuple[int, List[np.ndarray]]]:
    """Endless (pool index, prompts), the pool's batches in turn: each
    prompt an int64 array of token ids drawn from the Zipf law."""
    pool = prompt_lengths(mix)
    rng = np.random.default_rng(stream_seed(seed, PROMPT_STREAM))
    cdf = zipf_cdf(vocab, mix["zipf_exponent"])
    t = 0
    while True:
        j = t % len(pool)
        lengths = [pool[j][i] for i in rng.permutation(len(pool[j]))]
        prompts = [np.minimum(np.searchsorted(cdf, rng.random(n)), vocab - 1)
                   .astype(np.int64) for n in lengths]
        yield j, prompts
        t += 1

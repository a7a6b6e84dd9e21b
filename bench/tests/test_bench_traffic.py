"""The traffic generator: inputs are a function of the seed, the serving
pool is the same for every seed, and a mix or a metric added as a new file
runs with no edit to an existing one."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from bench import run as bench_run
from bench.common import traffic
from bench.tests.bench_helpers import ROOT, TINY_MIXES

TRAIN = json.loads((ROOT / "bench/traffic/train-2k.json").read_text())
SERVE = json.loads((ROOT / "bench/traffic/serve-code.json").read_text())


def test_training_rows_follow_the_seed_and_the_step():
    a = traffic.train_rows(TRAIN, 32000, 2**31 + 5, 3, "cpu")
    assert a.shape == (8, 2049) and a.dtype == torch.int64
    assert torch.equal(a, traffic.train_rows(TRAIN, 32000, 2**31 + 5, 3, "cpu"))
    assert not torch.equal(a, traffic.train_rows(TRAIN, 32000, 2**31 + 6, 3,
                                                 "cpu"))
    assert not torch.equal(a, traffic.train_rows(TRAIN, 32000, 2**31 + 5, 4,
                                                 "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 32000
    assert len({tuple(r.tolist()) for r in a}) == 8      # rows all differ


def test_zipf_law_puts_most_mass_on_few_ids():
    cdf = traffic.zipf_cdf(32000, TRAIN["zipf_exponent"])
    assert cdf[-1] == 1.0 and np.all(np.diff(cdf) > 0)
    assert 0.25 < cdf[9] < 0.5          # the ten most frequent ids


def test_serving_pool_is_the_same_for_every_seed():
    pool = traffic.prompt_lengths(SERVE)
    assert len(pool) == 4 and all(len(b) == 16 for b in pool)
    assert [max(b) for b in pool] == [5529, 6287, 7532, 8192]
    lengths = sorted(x for b in pool for x in b)
    assert lengths[0] >= 256 and 1400 < np.median(lengths) < 1700

    def first_round(seed):
        gen = traffic.serve_batches(SERVE, 32000, seed)
        return [next(gen) for _ in range(4)]

    a, b = first_round(2**31 + 1), first_round(7)
    assert [j for j, _ in a] == [j for j, _ in b] == [0, 1, 2, 3]
    for (_, pa), (_, pb), want in zip(a, b, pool):
        assert sorted(map(len, pa)) == sorted(map(len, pb)) == sorted(want)
        assert not all(np.array_equal(x, y) for x, y in zip(pa, pb))
    again = first_round(2**31 + 1)
    assert all(np.array_equal(x, y) for (_, pa), (_, pb) in zip(a, again)
               for x, y in zip(pa, pb))


def test_a_new_mix_and_metric_run_as_new_files_only(tiny_root):
    """A throwaway mix, its cell's limits and a new end-to-end metric: new
    files and new entries in BENCHMARK.json, no existing file edited."""
    metrics = tiny_root / "bench" / "metrics"
    os.unlink(metrics)
    shutil.copytree(ROOT / "bench" / "metrics", metrics)
    (metrics / "steps_done.py").write_text(
        "def read(rec):\n    return rec.get('steps')\n")
    mix = dict(TINY_MIXES["tiny-train"], batch=1, seq=24)
    (tiny_root / "bench/traffic/throwaway.json").write_text(json.dumps(mix))
    (tiny_root / "bench/limits/dense-throwaway.json").write_text(json.dumps(
        {"loss_rel": 1e-2, "grad_gap": 0.1, "change_gap": 0.1}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dense-throwaway",
                               "config": "tiny-dense", "traffic": "throwaway",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "steps_done", "unit": "steps",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["dense-throwaway"]})
    line = bench_run.run_cell(tiny_root, bench, "dense-throwaway", 3, 0.2,
                              False, torch.device("cpu"))
    assert line["correct"] and line["metrics"]["steps_done"]["value"] >= 1
    assert line["metrics"]["train_tokens_per_s"]["unit"] == "tokens/s"

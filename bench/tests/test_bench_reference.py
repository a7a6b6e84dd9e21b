"""The plain references: their scan and attention against the definitions,
the port's plain path within the limits of them at reduced widths, and the
float8 control (the reference in the program's place, one precision below
bfloat16) outside them."""

from __future__ import annotations

import json
import math

import pytest
import torch

from bench.calibrate import calibrate
from bench.common import compare
from bench.reference import common, ssm
from bench.tests.bench_helpers import TINY_CELLS, TINY_LIMITS, TINY_MIXES

SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


def _recurrence(x, dt, A, Bm, C):
    Bsz, S, H, P = x.shape
    s = torch.zeros(Bsz, H, P, Bm.shape[-1], dtype=x.dtype)
    ys = []
    for t in range(S):
        s = (s * torch.exp(dt[:, t] * A)[..., None, None]
             + torch.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t, :, None],
                            Bm[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", s, C[:, t]))
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("S,chunk", [(64, 16), (70, 16), (40, 64)])
def test_chunked_scan_is_the_recurrence(S, chunk):
    g = torch.Generator().manual_seed(S)
    x = torch.randn(2, S, 3, 4, generator=g, dtype=torch.float64)
    dt = torch.rand(2, S, 3, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(3, generator=g, dtype=torch.float64) * 2
    Bm = torch.randn(2, S, 5, generator=g, dtype=torch.float64)
    C = torch.randn(2, S, 5, generator=g, dtype=torch.float64)
    got = ssm.ssd(x, dt, A, Bm, C, chunk)
    torch.testing.assert_close(got, _recurrence(x, dt, A, Bm, C),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("window", [None, 7, 40])
def test_blocked_attention_is_masked_softmax(window):
    g = torch.Generator().manual_seed(5)
    B, S, H, KV, dh = 2, 37, 4, 2, 8
    q = torch.randn(B, S, H, dh, generator=g, dtype=torch.float64)
    k = torch.randn(B, S, KV, dh, generator=g, dtype=torch.float64)
    v = torch.randn(B, S, KV, dh, generator=g, dtype=torch.float64)
    got = common.attention(q, k, v, window, block=8)
    kk = k.repeat_interleave(H // KV, dim=2)
    vv = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(dh)
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    ok = (j <= i) & ((j > i - window) if window else True)
    want = torch.einsum("bhqk,bkhd->bqhd",
                        torch.softmax(s.masked_fill(~ok, -math.inf), -1), vv)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_float8_rounds_like_e4m3():
    x = torch.tensor([1.0, 1.0625, 1.1, -3.3, 448.0])
    got = common._Fp8.apply(x)
    assert got[0] == 1.0 and got[-1] == 448.0
    assert (got - x).abs().max() < 0.2 and not torch.equal(got, x)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_program_within_and_control_outside_the_limits(tiny_root, cell):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    kind = TINY_MIXES[TINY_CELLS[cell][1]]["kind"]
    limits = TINY_LIMITS[kind]
    lines = calibrate(tiny_root, bench, cell, SEEDS, set(SEEDS), set(),
                      torch.device("cpu"), emit=lambda s: None)
    for line in lines:
        values = {k: line[k] for k in limits}
        ok = compare.passed(compare.judge(values, limits))
        assert ok == (line["side"] == "program"), line

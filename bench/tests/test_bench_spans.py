"""The readers of the per-layer metrics that read the port's spans, on
synthetic records: means over steps and batches, sums over layers within a
decode step, the host-sync subtraction, and None wherever there is nothing
to read."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench.common import spans
from bench.common.cell import load_file
from bench.tests.bench_helpers import ROOT

TRAIN = {"kind": "train", "trace": {"steps": 2}}
SERVE = {"kind": "serve", "trace": {"batches": []}}


def reader(name):
    return load_file(ROOT / "bench" / "metrics" / f"{name}.py",
                     f"test_metric_{name.replace('.', '_')}").read


class Recs:
    """Builds records as ``repro_torch.spans`` holds them."""

    def __init__(self):
        self.all = []

    def add(self, name, parent=None, host=1.0, device=1.0):
        r = SimpleNamespace(name=name, parent=parent, host_ms=host,
                            device_ms=device)
        self.all.append(r)
        return r


def train_records(device=True, microbatches=1):
    """Two steps: optimizer 100 and 120 ms, backward 400 and 500 ms a
    step (split evenly over the microbatches)."""
    rs = Recs()
    for opt, bwd in ((100.0, 400.0), (120.0, 500.0)):
        step = rs.add("train.step", host=900.0, device=900.0)
        rs.add("train.batch", step)
        for i in range(microbatches):
            mb = rs.add("train.microbatch", step) if microbatches > 1 \
                else step
            rs.add("train.forward", mb, device=200.0)
            b = rs.add("train.backward", mb,
                       device=bwd / microbatches if device else None)
            layer = rs.add("model.layer", b, device=30.0)
            rs.add("model.attention", layer, device=7.0)
        rs.add("train.optimizer", step, device=opt if device else None)
    return rs.all


def serve_records(device=True):
    """Two batches of three decode steps over two layers: attention 2 and
    3 ms a layer (5 a step) in the first batch, 4 and 4 (8) in the second;
    decode steps of 60 host ms, of which the host sync takes 20 ms (first
    batch) and 10 ms (second)."""
    rs = Recs()
    for attn, sync in (((2.0, 3.0), 20.0), ((4.0, 4.0), 10.0)):
        run = rs.add("serve.run")
        rs.add("serve.submit", run)
        pre = rs.add("serve.prefill", run)
        for i, ms in enumerate(attn):     # prefill's attention: not read
            lay = rs.add("model.layer", pre)
            rs.add("model.attention", lay, device=1000.0)
        for t in range(3):
            step = rs.add("serve.decode_step", run, host=60.0, device=55.0)
            rs.add("serve.host_sync", step, host=sync)
            for ms in attn:
                lay = rs.add("model.layer", step, device=ms + 1)
                rs.add("model.norm", lay, device=0.5)
                rs.add("model.attention", lay,
                       device=ms if device else None)
    return rs.all


@pytest.mark.parametrize("name,cell,records,want", [
    ("optimizer_ms.train", TRAIN, train_records(), 110.0),
    ("optimizer_ms.train", TRAIN, train_records(microbatches=3), 110.0),
    ("backward_ms.train", TRAIN, train_records(), 450.0),
    ("backward_ms.train", TRAIN, train_records(microbatches=2), 450.0),
    ("optimizer_ms.train", TRAIN, train_records(microbatches=2), 110.0),
    ("backward_ms.train", TRAIN, train_records(microbatches=3), 450.0),
    ("decode_host_ms.serve", SERVE, serve_records(), 45.0),
])
def test_reading(monkeypatch, name, cell, records, want):
    monkeypatch.setattr(spans, "program_records", lambda: records)
    assert reader(name)(cell) == pytest.approx(want)


@pytest.mark.parametrize("name,cell,records", [
    ("optimizer_ms.train", TRAIN, None),          # a port without spans
    ("optimizer_ms.train", TRAIN, []),
    ("backward_ms.train", TRAIN, train_records(device=False)),
    ("optimizer_ms.train", TRAIN, train_records(device=False)),
    ("optimizer_ms.train", SERVE, train_records()),
    ("backward_ms.train", {"kind": "train", "trace": None},
     train_records()),
    ("backward_ms.train", SERVE, serve_records()),
    ("optimizer_ms.train", TRAIN, serve_records()),
    ("decode_host_ms.serve", SERVE, train_records()),
    ("decode_host_ms.serve", SERVE, []),
    ("decode_host_ms.serve", TRAIN, serve_records()),
    ("decode_host_ms.serve", {"kind": "serve", "trace": None},
     serve_records()),
])
def test_nothing_to_read_reads_none(monkeypatch, name, cell, records):
    monkeypatch.setattr(spans, "program_records", lambda: records)
    assert reader(name)(cell) is None


@pytest.mark.parametrize("device,want", [(True, 6.5), (False, None)])
def test_a_decode_step_sums_its_layers(device, want):
    """Each decode step's ``model.attention`` spans, summed over its layers
    (prefill's left out), over the steps of both batches."""
    got = spans.mean_within(serve_records(device), "model.attention",
                            "serve.decode_step")
    assert got == (pytest.approx(want) if want is not None else None)


def test_the_port_s_records_are_read_when_it_has_spans():
    from repro_torch import spans as port_spans
    assert spans.program_records() == port_spans.records()

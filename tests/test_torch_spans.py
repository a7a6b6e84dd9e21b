"""The port's spans (``repro_torch.spans``) on the CPU: off unless a
``torch.profiler`` runs, the train step's and ``Server.run``'s spans and
their parents under one, the profiler's host events of the same names, no
value changed by tracing, the buffer's bound, and ``run_loop``'s data wait.
Tiny presets, fixed seeds."""

import collections
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import preset_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train.loop import LoopConfig, run_loop  # noqa: E402
from repro_torch.train.trainer import init_state, make_train_step  # noqa: E402


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.clear()
    yield
    spans.clear()


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def _train(arch, seq=32, batch=2):
    cfg = preset_config(arch, "smoke")
    model = Model(cfg, device="cpu")
    opt = AdamW()
    state = init_state(model, opt, 0)
    data = SyntheticLMData.for_config(cfg, seq, batch, seed=0)
    return cfg, make_train_step(model, opt), state, data


def _serve(lengths=(7, 12, 9), max_new=(4, 4, 2)):
    cfg = preset_config("h2o-danube-1.8b", "smoke")
    model = Model(cfg, device="cpu")
    srv = serve.Server(model, model.init(0), len(lengths), max_seq=24,
                       device="cpu")
    rng = np.random.default_rng(0)
    return srv, [serve.Request(rid=10 + i, prompt=rng.integers(
        1, cfg.vocab_size, n), max_new=k)
        for i, (n, k) in enumerate(zip(lengths, max_new))]


def _ancestor(rec, name):
    while rec is not None and rec.name != name:
        rec = rec.parent
    return rec


def test_off_records_nothing_and_returns_the_shared_null_context():
    assert spans.span("a") is spans.span("b", x=1)
    with spans.span("a") as s:
        assert s is None
    _, step, state, data = _train("h2o-danube-1.8b")
    step(state, data.batch(0))
    srv, reqs = _serve()
    srv.run(reqs)
    assert spans.records() == []


def test_a_dense_step_with_remat_nests_its_spans():
    cfg, step, state, data = _train("h2o-danube-1.8b")
    with traced() as prof:
        step(state, data.batch(0))
    recs = spans.records()
    (top,) = [r for r in recs if r.name == "train.step"]
    assert top.parent is None and top.attrs == {"step": 0, "tokens": 64}
    kids = [r.name for r in recs if r.parent is top]
    assert kids == ["train.batch", "train.forward", "train.backward",
                    "train.optimizer"]
    (opt,) = [r for r in recs if r.name == "train.optimizer"]
    leaves = pytree.tree_leaves(state.params)
    assert opt.attrs == {"leaves": len(leaves),
                         "elements": sum(p.numel() for p in leaves),
                         "launches": 0}   # the plain loop on the CPU
    layers = collections.Counter(
        (r.attrs["layer"], r.parent.name) for r in recs
        if r.name == "model.layer")
    assert layers == {(i, part): 1 for i in range(cfg.n_layers)
                      for part in ("train.forward", "train.backward")}
    (loss,) = [r for r in recs if r.name == "model.loss"]
    assert loss.parent.name == "train.forward"
    for name, parents in (("model.attention", {"model.layer"}),
                          ("model.mlp", {"model.layer"}),
                          ("model.norm", {"model.layer", "train.forward"}),
                          ("model.embed", {"train.forward"})):
        assert {r.parent.name for r in recs if r.name == name} == parents
    # Every span is a host event of the profiler's, under the same name.
    host = collections.Counter(e.name for e in prof.events())
    for name, n in collections.Counter(r.name for r in recs).items():
        assert host[name] == n, name
    assert all(r.host_ms >= 0 and r.device_ms is None for r in recs)
    # Only the backward and the update take CUDA events (none on the CPU).
    assert {r.name for r in recs if r.timed} == {"train.backward",
                                                 "train.optimizer"}
    assert top.host_ms >= sum(r.host_ms for r in recs if r.parent is top)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-370m"])
def test_tracing_changes_no_bit_of_the_step(arch):
    _, step, a, data = _train(arch)
    _, _, b, _ = _train(arch)
    la = step(a, data.batch(0))[1]["loss"]
    with traced():
        lb = step(b, data.batch(0))[1]["loss"]
    assert spans.records()
    assert torch.equal(la, lb)
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        assert torch.equal(x, y)


def test_a_mamba2_step_records_its_block_spans_per_layer():
    cfg, step, state, data = _train("mamba2-370m")
    with traced():
        step(state, data.batch(0))
    recs = spans.records()
    for name in ("ssm.conv", "ssm.scan", "ssm.gate_norm"):
        got = collections.Counter(
            (_ancestor(r, "model.layer").attrs["layer"],
             _ancestor(r, "train.backward") is not None)
            for r in recs if r.name == name)
        assert got == {(i, bwd): 1 for i in range(cfg.n_layers)
                       for bwd in (False, True)}, name
        assert {r.parent.name for r in recs if r.name == name} == {
            "model.ssm"}


def test_microbatches_repeat_forward_and_backward():
    cfg = preset_config("h2o-danube-1.8b", "smoke")
    model = Model(cfg, device="cpu")
    opt = AdamW()
    step = make_train_step(model, opt, microbatches=2)
    data = SyntheticLMData.for_config(cfg, 32, 4, seed=0)
    with traced():
        step(init_state(model, opt, 0), data.batch(0))
    recs = spans.records()
    mbs = [r for r in recs if r.name == "train.microbatch"]
    assert [r.attrs["mb"] for r in mbs] == [0, 1]
    assert [r.parent.name for r in recs if r.name in (
        "train.forward", "train.backward")] == ["train.microbatch"] * 4


def test_server_run_records_each_decode_step_and_first_token():
    srv, reqs = _serve()
    with traced():
        stats = srv.run(reqs)
    recs = spans.records()
    (run,) = [r for r in recs if r.name == "serve.run"]
    assert run.attrs["rids"] == [10, 11, 12]
    first = run.attrs["first_token_ns"]
    assert sorted(first) == [10, 11, 12]
    assert all(run.start_ns < ns < run.end_ns for ns in first.values())
    (prefill,) = [r for r in recs if r.name == "serve.prefill"]
    # k and v: 2 layers x 3 rows x 24 slots x 2 kv heads x 16 x 2 bytes.
    assert prefill.attrs == {"positions": 3 * 12, "prompt_tokens": 28,
                             "kv_bytes": 2 * 2 * 3 * 24 * 2 * 16 * 2,
                             "state_bytes": 0}
    assert [r.name for r in recs if r.parent is run] == [
        "serve.submit", "serve.prefill"] + ["serve.decode_step"] * 4
    steps = [r for r in recs if r.name == "serve.decode_step"]
    assert [(r.attrs["t"], r.attrs["active"]) for r in steps] == [
        (0, 3), (1, 3), (2, 2), (3, 2)]
    syncs = [r for r in recs if r.name == "serve.host_sync"]
    assert [r.parent for r in syncs] == steps
    assert stats["new_tokens"] == 10
    # model.attention in a decode step wraps decode_attn, once a layer.
    n_layers = srv.model.cfg.n_layers
    for s in steps:
        attn = [r for r in recs if r.name == "model.attention"
                and _ancestor(r, "serve.decode_step") is s]
        assert len(attn) == n_layers


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-370m",
                                  "recurrentgemma-2b", "whisper-base",
                                  "moonshot-v1-16b-a3b"])
def test_prefill_and_decode_record_each_layer_once(arch):
    cfg = preset_config(arch, "smoke")
    model = Model(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 6)))
    logits, cache = model.prefill(params, serve.prompt_batch(cfg, tokens),
                                  max_seq=12)
    with traced():
        pre = model.prefill(params, serve.prompt_batch(cfg, tokens),
                            max_seq=12)
        dec = model.decode_step(params, pre[1], model.greedy(pre[0]), 6)
    ref = model.decode_step(params, cache, model.greedy(logits), 6)
    assert torch.equal(pre[0], logits) and torch.equal(dec[0], ref[0])
    layers = [r for r in spans.records() if r.name == "model.layer"]
    encoder = [r.attrs["layer"] for r in layers if r.attrs.get("encoder")]
    decoder = [r.attrs["layer"] for r in layers
               if not r.attrs.get("encoder")]
    assert decoder == list(range(cfg.n_layers)) * 2
    assert encoder == list(range(cfg.n_enc_layers))
    assert all(r.parent is None or r.parent.name != "model.layer"
               for r in layers)


def test_the_buffer_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 5)
    with traced():
        for i in range(12):
            with spans.span("s", i=i):
                pass
    assert [r.attrs["i"] for r in spans.records()] == [7, 8, 9, 10, 11]


def test_a_thread_with_no_open_span_adopts_the_newest_open_one():
    """As the autograd engine's device thread does for the recompute."""
    seen = {}

    def worker():
        with spans.span("inner") as s:
            seen["parent"] = s.parent

    with traced():
        with spans.span("train.backward") as outer:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert seen["parent"] is outer


def test_spanned_functions_record_a_span_each_call():
    @spans.spanned("f")
    def f(x):
        """doc"""
        return x + 1

    assert f(1) == 2 and spans.records() == []
    with traced():
        assert f(2) == 3
    assert [r.name for r in spans.records()] == ["f"]
    assert f.__doc__ == "doc" and f.__name__ == "f"


def test_the_loop_writes_each_step_s_data_wait(tmp_path):
    class SlowData:
        def batch(self, step):
            time.sleep(0.02)
            return {"x": torch.tensor(float(step))}

    def step_fn(state, batch):
        return state + batch["x"], {"loss": state}

    path = tmp_path / "metrics.jsonl"
    with traced():
        run_loop(step_fn, torch.tensor(0.0), SlowData(),
                 LoopConfig(total_steps=3, log_every=0,
                            metrics_path=str(path)), log=lambda *_: None)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert all(r["data_s"] >= 0.02 and r["time_s"] >= 0 for r in rows)
    waits = [r for r in spans.records() if r.name == "loop.data"]
    assert len(waits) == 3 and all(r.host_ms >= 20 for r in waits)

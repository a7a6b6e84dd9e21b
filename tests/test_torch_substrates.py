"""The port's data pipeline, optimizer, gradient compression, checkpoints
and fault-tolerant loop: twins of the JAX package's
``tests/test_substrates.py``, each held to the reference where both
compute the same thing (the data bit for bit, the schedule and the int8
codes exactly), plus the resume race the reference's loop has (ROADMAP.md
Queue 3): the port's loop resumes after the step it restored."""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.data.pipeline import SyntheticLMData as RData  # noqa: E402
from repro.optim.adamw import cosine_schedule as rcosine  # noqa: E402
from repro.optim.compression import compress_int8 as rcompress  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.optim.adamw import AdamW, cosine_schedule  # noqa: E402
from repro_torch.optim.compression import (compress_int8,  # noqa: E402
                                           compress_tree, decompress_int8,
                                           init_compression)
from repro_torch.train import loop as loop_mod  # noqa: E402
from repro_torch.train.loop import LoopConfig, run_loop  # noqa: E402


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["copy", "succ", "zipf"])
def test_data_is_the_references_bit_for_bit(mode):
    kw = dict(vocab_size=300, seq_len=24, global_batch=6, seed=5, mode=mode,
              n_patches=3, n_frames=4, d_model=8)
    got, want = SyntheticLMData(**kw), RData(**kw)
    for step in (0, 7):
        for shard, n in ((0, 1), (1, 3)):
            g, w = got.batch(step, shard, n), want.batch(step, shard, n)
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


def test_data_deterministic_across_restarts():
    d = SyntheticLMData(vocab_size=100, seq_len=16, global_batch=8, seed=3)
    b1 = d.batch(step=5)
    b2 = SyntheticLMData(vocab_size=100, seq_len=16, global_batch=8,
                         seed=3).batch(step=5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], d.batch(step=6)["tokens"])


def test_data_sharding_consistency():
    d = SyntheticLMData(vocab_size=100, seq_len=16, global_batch=8, seed=1)
    full = d.batch(step=2)
    parts = [d.batch(step=2, shard=s, n_shards=4) for s in range(4)]
    np.testing.assert_array_equal(
        full["tokens"], np.concatenate([p["tokens"] for p in parts]))
    with pytest.raises(ValueError):
        d.batch(step=2, shard=0, n_shards=3)


@pytest.mark.parametrize("mode", ["copy", "succ", "zipf"])
def test_data_labels_are_shifted_tokens(mode):
    d = SyntheticLMData(vocab_size=50, seq_len=12, global_batch=2, seed=0,
                        mode=mode)
    b = d.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# -- optimizer ------------------------------------------------------------------


def test_adamw_descends_quadratic():
    opt = AdamW(learning_rate=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 0.5


def test_adamw_clipping_and_schedule():
    sched = cosine_schedule(1.0, warmup=10, total=100)
    assert float(sched(0)) == pytest.approx(0.0)
    assert float(sched(10)) == pytest.approx(1.0, rel=1e-2)
    assert float(sched(100)) == pytest.approx(0.1, rel=1e-2)
    opt = AdamW(learning_rate=1e-2, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    new, state, m = opt.update({"w": torch.full((3,), 1e6)}, state, params)
    assert float(m["grad_norm"]) > 1e5
    assert float(new["w"].abs().max()) < 1.0  # clipped step
    assert int(state.count) == 1


def test_schedule_is_the_references():
    got, want = cosine_schedule(3e-3, 20, 300), rcosine(3e-3, 20, 300)
    for step in (0, 1, 19, 20, 21, 150, 299, 300, 400):
        assert float(got(step)) == pytest.approx(float(want(step)), rel=1e-6)


def test_int8_compression_roundtrip_error_bounded(rng):
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    q, s = compress_int8(x)
    assert q.dtype == torch.int8
    y = decompress_int8(q, s)
    assert float((x - y).abs().max()) <= float(s) * 0.5 + 1e-7
    rq, rs = rcompress(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)


def test_compress_tree_carries_the_error_forward(rng):
    grads = {"a": torch.from_numpy(rng.standard_normal((4, 5)).astype(
        np.float32)), "b": [torch.from_numpy(rng.standard_normal(7).astype(
            np.float32))]}
    state = init_compression(grads)
    qs, deq, state = compress_tree(grads, state)
    assert qs["a"][0].dtype == torch.int8
    for g, d, e in zip((grads["a"], grads["b"][0]), (deq["a"], deq["b"][0]),
                       (state.error["a"], state.error["b"][0])):
        torch.testing.assert_close(d + e, g, rtol=0, atol=1e-6)


# -- checkpointing ---------------------------------------------------------------


def tree_example():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32),
                  "d": (torch.zeros(4), torch.ones((2, 2),
                                                  dtype=torch.bfloat16))}}




def test_checkpoint_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    tree = tree_example()
    store.save(3, tree, blocking=True)
    like = {"a": torch.zeros(2, 3),
            "b": {"c": torch.zeros(3, dtype=torch.int32),
                  "d": (torch.ones(4),
                        torch.zeros((2, 2), dtype=torch.bfloat16))}}
    out, step = store.restore(like)
    assert step == 3
    for a, b in zip(pytree.tree_leaves(tree), pytree.tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert sorted(os.listdir(tmp_path / "step_000003")) == [
        "leaf_00000.npy", "leaf_00001.npy", "leaf_00002.npy",
        "leaf_00003.npy", "manifest.json"]


def test_checkpoint_snapshot_is_taken_at_save(tmp_path):
    """The save copies the leaves before returning: an in-place update right
    after it (the optimizer's) does not reach the files."""
    store = CheckpointStore(str(tmp_path))
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    store.save(0, tree)
    tree["w"].add_(100.0)
    store.wait()
    out, _ = store.restore({"w": torch.zeros(4)})
    assert torch.equal(out["w"], torch.arange(4, dtype=torch.float32))


def test_checkpoint_retention_and_latest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    tree = tree_example()
    for s in (1, 5, 9):
        store.save(s, tree, blocking=True)
    assert store.steps() == [5, 9]
    assert store.latest_step() == 9
    assert store.restore(tree, step=5)[1] == 5


def test_checkpoint_atomicity(tmp_path):
    """A stale .tmp dir (crashed writer) must not be visible as a
    checkpoint."""
    store = CheckpointStore(str(tmp_path), keep=3)
    os.makedirs(os.path.join(str(tmp_path), "step_000777.tmp"))
    assert store.latest_step() is None
    with pytest.raises(FileNotFoundError):
        store.restore(tree_example())
    store.save(1, tree_example(), blocking=True)
    assert store.latest_step() == 1


def test_checkpoint_restore_rejects_another_tree(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(0, {"w": torch.zeros(3)}, blocking=True)
    with pytest.raises(ValueError):
        store.restore({"w": torch.zeros(3), "x": torch.zeros(1)})
    with pytest.raises(ValueError):
        store.restore({"w": torch.zeros(4)})


# -- fault-tolerant loop ----------------------------------------------------------


class ToyData:
    def batch(self, step):
        return {"x": torch.tensor([float(step)])}


def toy_step(state, batch):
    new = state + batch["x"][0]
    return new, {"loss": new}


def test_loop_checkpoint_restart(tmp_path):
    ckdir = str(tmp_path / "ck")
    cfg = LoopConfig(total_steps=10, checkpoint_every=3, checkpoint_dir=ckdir,
                     log_every=0)
    out = run_loop(toy_step, torch.tensor(0.0), ToyData(), cfg,
                   log=lambda *_: None)
    assert out["final_step"] == 10
    out2 = run_loop(toy_step, torch.tensor(0.0), ToyData(),
                    LoopConfig(total_steps=10, checkpoint_dir=ckdir,
                               log_every=0), log=lambda *_: None)
    assert float(out2["state"]) == float(out["state"])
    assert out2["losses"] == []


def test_loop_failure_recovery(tmp_path):
    """A simulated node failure mid-run: the loop restores the latest
    checkpoint, replays the lost steps and reaches the same final state."""
    ckdir = str(tmp_path / "ck")
    fail_at = {"armed": True}

    def failure_hook(step):
        if step == 7 and fail_at["armed"]:
            fail_at["armed"] = False
            raise RuntimeError("simulated device loss")

    cfg = LoopConfig(total_steps=10, checkpoint_every=2, checkpoint_dir=ckdir,
                     log_every=0)
    out = run_loop(toy_step, torch.tensor(0.0), ToyData(), cfg,
                   failure_hook=failure_hook, log=lambda *_: None)
    assert out["recoveries"] == 1
    assert out["final_step"] == 10
    assert float(out["state"]) == pytest.approx(sum(range(10)))
    # steps 0-6 ran, then 7-9 after restoring step 6's checkpoint
    assert out["loss_steps"] == list(range(10))


def test_loop_resumes_after_the_step_it_restored(tmp_path, monkeypatch):
    """The reference's resume race, made deterministic: the store's
    ``latest_step()`` moves (an async save publishing) between the restore
    and any later read.  The port's loop takes the step from the checkpoint
    it restored, so it replays every lost step and sums 0..9; the
    reference's re-read would resume after step 8 with step 4's state."""
    ckdir = str(tmp_path / "ck")

    class RacingStore(CheckpointStore):
        def restore(self, like, step=None):
            out = super().restore(like, step)
            # a newer checkpoint is published right after the restore
            super().save(8, torch.tensor(-1000.0), blocking=True)
            return out

    monkeypatch.setattr(loop_mod, "CheckpointStore", RacingStore)
    fail_at = {"armed": True}

    def failure_hook(step):
        if step == 6 and fail_at["armed"]:
            fail_at["armed"] = False
            raise RuntimeError("simulated device loss")

    cfg = LoopConfig(total_steps=10, checkpoint_every=4, checkpoint_dir=ckdir,
                     log_every=0)
    out = run_loop(toy_step, torch.tensor(0.0), ToyData(), cfg,
                   failure_hook=failure_hook, log=lambda *_: None)
    assert out["recoveries"] == 1
    assert out["loss_steps"] == [0, 1, 2, 3, 4, 5, 5, 6, 7, 8, 9]
    assert float(out["state"]) == pytest.approx(sum(range(10)))


def test_loop_straggler_watchdog():
    def slow_step(state, batch):
        time.sleep(0.35 if int(batch["x"][0]) == 8 else 0.01)
        return state + 1, {"loss": state}

    out = run_loop(slow_step, torch.tensor(0.0), ToyData(),
                   LoopConfig(total_steps=10, log_every=0),
                   log=lambda *_: None)
    assert out["stragglers"] >= 1
    assert out["final_step"] == 10

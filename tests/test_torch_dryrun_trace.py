"""The port's dry-run trace: cells traced with fake tensors on fake-group
meshes, the collective counter against a hand count, the memory tally
against the state's own bytes, per-device FLOPs under data parallelism,
the probe correction at one microbatch, and the command line.

Nothing here allocates a model: every tensor is fake, and the meshes'
collectives move nothing."""

import dataclasses
import json

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import partition
from repro_torch.configs import registry
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models.layers import COMPUTE_DTYPE

torch.set_num_threads(2)

DENSE = "h2o-danube-1.8b"


def _small(layers=2):
    return dataclasses.replace(registry.get_config(DENSE).reduced(),
                               n_layers=layers)


def test_cell_on_mini_mesh():
    """The twin of the reference's ``test_dryrun_cell_on_mini_mesh``:
    whisper-base's training step at full width on a 4 x 4 mesh, one
    microbatch of 16 rows; no process group is left running."""
    with fake_mesh((4, 4)) as mesh:
        tr, meta = dr.trace_cell("whisper-base", "train_4k", mesh,
                                 batch_rows=16, microbatches=1)
        cap = dr.capture(tr)
    assert not dist.is_initialized()
    assert meta["microbatches"] == 1
    assert cap["cost"]["flops"] > 0
    assert cap["collectives"]["n_collectives"] > 0
    assert cap["memory"]["live_bytes"] > 0
    # Every weight is gathered (FSDP) and its gradient reduce-scattered.
    per_op = cap["collectives"]["per_op_operand_bytes"]
    assert per_op["all-gather"] > 0 and per_op["reduce-scatter"] > 0
    assert cap["memory"]["alias_size_in_bytes"] > 0      # the state, in place


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_cells_under_serve_rules(shape):
    """A prefill and a decode of a reduced config on a 2 x 2 mesh under
    ``serve_rules``: each model rank computes its heads, ff columns and
    vocab columns, so both count the row-parallel sums as all-reduces (the
    decode also the flash-decode's combines over the sharded cache, three
    a layer) and the gathers of the fused MLP weight and of the kv heads
    for the cache as all-gathers; the decode's cache is its argument,
    updated in place."""
    with fake_mesh((2, 2)) as mesh:
        tr, meta = dr.trace_cell(DENSE, shape, mesh, cfg=_small(),
                                 batch_rows=4, rules_kind="serve")
        cap = dr.capture(tr)
    per_op = cap["collectives"]["per_op_operand_bytes"]
    assert cap["cost"]["flops"] > 0 and per_op["all-gather"] > 0
    assert per_op["all-reduce"] > 0 and meta["repeated_blocks"] == {}
    if shape == "decode_32k":
        assert cap["memory"]["alias_size_in_bytes"] > 0
    else:
        assert cap["memory"]["output_size_in_bytes"] > 0


def test_collective_counter_hand_count():
    """One ``wcast`` of a [64, 32] float32 weight sharded (data, model) on a
    2 x 2 mesh: two all-gathers of bfloat16, one over each mesh dim, whose
    results are half and all of the weight: operands 1,024 + 2,048 bytes,
    ring wire bytes (n - 1) / n of each result with n = 2."""
    with fake_mesh((2, 2)) as mesh, FakeTensorMode():
        rules = partition.fsdp_rules(mesh, 4)
        shard = rules.sharding(("embed", "ff"))
        w = partition.place(torch.empty((64, 32), device=dr.trace_device()),
                            shard, local=True)
        assert w.to_local().shape == (32, 16)
        with partition.use_rules(rules), dr.CollectiveCounter() as coll:
            full = partition.wcast(w, COMPUTE_DTYPE, ("embed", "ff"))
    assert full.shape == (64, 32) and full.dtype == COMPUTE_DTYPE
    assert coll.record() == {
        "per_op_operand_bytes": {"all-gather": 1024 / 2 * 2 + 2048},
        "operand_bytes": 3072.0, "ring_wire_bytes": 3072.0,
        "n_collectives": 2}


def test_memory_tally_counts_the_state_and_frees_the_rest():
    """On a one-rank mesh the arguments are the whole state (parameters,
    two moments, two counters) and the batch, each storage rounded to the
    allocator's 512 bytes; after the step only they are live, the outputs
    that alias them are the state but for the step and AdamW's count
    (new scalars), and the peak holds the step's activations on top."""
    with fake_mesh((1, 1)) as mesh, FakeTensorMode():
        fn, args, _, donate, rules, mb = dr.build_cell(
            DENSE, "train_4k", mesh, cfg=_small(), batch_rows=2,
            microbatches=1)
        state, batch = args
        leaves = [t.to_local() for t in torch.utils._pytree.tree_leaves(
            state)] + list(batch.values())
        want = sum(-(-t.numel() * t.element_size() // 512) * 512
                   for t in leaves)
        with partition.use_rules(rules):
            tr = dr.trace_call(fn, args, 1, rules.size("batch"))
    cap = dr.capture(tr)
    mem = cap["memory"]
    assert donate == (0,) and mb == 1
    assert mem["argument_size_in_bytes"] == want
    assert tr.tally.current == want
    assert mem["alias_size_in_bytes"] == want - sum(
        -(-t.numel() * t.element_size() // 512) * 512
        for t in batch.values()) - 2 * 512  # the counters are new tensors
    assert mem["temp_size_in_bytes"] > 0
    assert mem["live_bytes"] == tr.tally.peak


def test_data_parallel_halves_the_flops():
    """Two data ranks each run half the batch: per-device FLOPs of a (2, 1)
    mesh are exactly half of a (1, 1) mesh's; the gradient sum and the
    loss's mean are all-reduces only on the two ranks."""
    caps = {}
    for shape in ((1, 1), (2, 1)):
        with fake_mesh(shape) as mesh:
            tr, _ = dr.trace_cell(DENSE, "train_4k", mesh, cfg=_small(),
                                  batch_rows=4, microbatches=1)
            caps[shape] = dr.capture(tr)
    one, two = caps[(1, 1)]["cost"]["flops"], caps[(2, 1)]["cost"]["flops"]
    assert one > 0 and two * 2 == one


def test_the_model_axis_splits_the_matmuls():
    """A reduced danube's training step on a fake (1, 4) mesh: each model
    rank computes a quarter of the heads, ff columns and vocab, and its
    K/V for the one kv head its query heads use, so its ``aten.mm`` FLOPs
    are at most 0.3 of the (1, 1) trace's (the two kv heads' projections
    are halved, not quartered), with no block repeated."""
    mm = {}
    for shape in ((1, 1), (1, 4)):
        with fake_mesh(shape) as mesh:
            tr, meta = dr.trace_cell(DENSE, "train_4k", mesh, cfg=_small(),
                                     batch_rows=4, microbatches=1)
        mm[shape] = tr.flops.get_flop_counts()["Global"][torch.ops.aten.mm]
        assert meta["repeated_blocks"] == {}
    assert 0 < mm[(1, 4)] <= 0.3 * mm[(1, 1)]


def test_whisper_repeats_its_attention_on_sixteen_model_ranks():
    """whisper-base's 8 heads do not split over a 16-rank model axis: its
    decode step repeats each attention block (self and cross, every
    layer) on every rank and counts it; its ff and vocab split."""
    cfg = registry.get_config("whisper-base")
    with fake_mesh((1, 16)) as mesh:
        _, meta = dr.trace_cell("whisper-base", "decode_32k", mesh)
    assert meta["repeated_blocks"] == {"attention": 2 * cfg.n_layers}


def test_probes_correct_to_the_full_trace():
    """The port traces every layer, so at one microbatch the probe
    correction of a 4-layer dense config equals its full trace's FLOPs."""
    cfg = _small(4)
    with fake_mesh((2, 2)) as mesh:
        kw = dict(batch_rows=4, microbatches=1)
        full = dr.capture(dr.trace_cell(DENSE, "train_4k", mesh, cfg=cfg,
                                        **kw)[0])
        rec = {"microbatches": 1, "probes": {
            f"u{u}": dr.capture(dr.trace_cell(
                DENSE, "train_4k", mesh, cfg=dr._probe_cfg(cfg, u), **kw)[0])
            for u in (1, 2)}}
    got = dr.correct(rec, cfg)
    assert got["flops"] == full["cost"]["flops"]
    assert got["flops_per_unit"] > 0 and got["flops_fixed"] > 0


def test_fake_mesh_refuses_a_running_group():
    with fake_mesh((2, 1)):
        with pytest.raises(RuntimeError, match="already running"):
            with fake_mesh((2, 1)):
                pass
    assert not dist.is_initialized()


def test_command_line(tmp_path, capsys):
    dr.main(["--list"])
    lines = capsys.readouterr().out.splitlines()
    assert [tuple(line.split()) for line in lines] == registry.list_cells()
    dr.main(["--arch", "whisper-base", "--shape", "decode_32k", "--mesh",
             "single", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("OK  whisper-base/decode_32k/single mb=1")
    rec = json.loads((tmp_path /
                      "whisper-base__decode_32k__single__baseline.json")
                     .read_text())
    assert rec["ok"] and rec["device"] == dr.trace_device()
    for key in ("memory", "cost", "collectives", "n_ops"):
        assert key in rec["full"]
    for key in ("hbm_napkin", "probes", "corrected", "trace_s"):
        assert key in rec
    dr.main(["--arch", "whisper-base", "--shape", "long_500k"])
    assert capsys.readouterr().out.startswith("SKIP whisper-base/long_500k")
    assert not dist.is_initialized()

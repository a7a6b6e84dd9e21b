"""The port's dry-run arithmetic against the JAX package's: the registry
(cells, skips, input shapes, dtypes and logical axes), the microbatch
policy, the unit counts, the HBM napkin, the probe correction and the HLO
collective parser, cell by cell.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices
for the process that imports it (the reference's first lines; the test
session's JAX backend is already up, ``tests/conftest.py``), so every
import of the reference's dry-run stays in this file."""

import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import dryrun as jdr
from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun as tdr
from repro_torch.launch.mesh import fake_mesh

ALL_PAIRS = [(a, s) for a in jreg.ARCHS for s in jreg.SHAPES]


class FakeMesh:
    """The reference tests' mesh stand-in: axis names and a shape dict."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def test_registry_tables_equal_the_reference():
    assert treg.ARCHS == jreg.ARCHS
    assert list(treg.SHAPES) == list(jreg.SHAPES)
    for name, spec in jreg.SHAPES.items():
        mine = treg.SHAPES[name]
        assert (mine.name, mine.seq_len, mine.global_batch, mine.mode) == (
            spec.name, spec.seq_len, spec.global_batch, spec.mode)
    assert treg.LONG_CONTEXT_OK == jreg.LONG_CONTEXT_OK


def test_list_cells_equal_the_reference():
    assert treg.list_cells() == jreg.list_cells() == treg.CELLS
    assert len(treg.CELLS) == 33
    assert treg.list_cells(include_skipped=True) == jreg.list_cells(
        include_skipped=True)
    skipped = [(a, s) for a, s in ALL_PAIRS if treg.cell_skip_reason(a, s)]
    assert len(skipped) == 7 and all(s == "long_500k" for _, s in skipped)
    for a, s in ALL_PAIRS:
        assert treg.cell_skip_reason(a, s) == jreg.cell_skip_reason(a, s)


@pytest.mark.parametrize("arch,shape", ALL_PAIRS)
def test_input_specs_and_axes_equal_the_reference(arch, shape):
    want = jreg.input_specs(arch, shape)
    got = treg.input_specs(arch, shape)
    assert list(got) == list(want)
    for k, spec in want.items():
        assert got[k].shape == tuple(spec.shape)
        assert str(got[k].dtype).removeprefix("torch.") == \
            np.dtype(spec.dtype).name
    assert treg.input_logical_axes(arch, shape) == \
        jreg.input_logical_axes(arch, shape)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", jreg.list_cells())
def test_choose_microbatches_and_napkin_equal_the_reference(arch, shape,
                                                            mesh):
    m = MESHES[mesh]
    cfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    spec, jspec = treg.SHAPES[shape], jreg.SHAPES[shape]
    mb = jdr.choose_microbatches(jcfg, jspec, m)
    assert tdr.choose_microbatches(cfg, spec, m) == mb
    assert tdr.dp_size(m) == jdr.dp_size(m)
    want = jdr.hbm_napkin(jcfg, jspec, m, mb)
    got = tdr.hbm_napkin(cfg, spec, m, mb)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=0)


def test_mesh_sizes_read_a_device_mesh_as_the_fake_mesh():
    """The arithmetic reads a torch ``DeviceMesh`` (names and per-dim
    sizes) as it reads the reference tests' stand-in."""
    for kind, m in MESHES.items():
        shape = tuple(m.shape.values())
        with fake_mesh(shape, m.axis_names) as mesh:
            assert tdr.mesh_sizes(mesh) == m.shape
            cfg, spec = treg.get_config("qwen2-72b"), treg.SHAPES["train_4k"]
            assert tdr.choose_microbatches(cfg, spec, mesh) == \
                jdr.choose_microbatches(jreg.get_config("qwen2-72b"),
                                        jreg.SHAPES["train_4k"], m)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_n_units_and_probe_configs_equal_the_reference(arch):
    cfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    assert tdr.n_units(cfg) == jdr.n_units(jcfg)
    for units in (1, 2):
        mine, theirs = tdr._probe_cfg(cfg, units), jdr._probe_cfg(jcfg, units)
        assert (mine.n_layers, mine.n_enc_layers) == (theirs.n_layers,
                                                      theirs.n_enc_layers)


def test_correct_equals_the_reference():
    cfg = treg.get_config("stablelm-12b")
    rec = {
        "microbatches": 4,
        "probes": {
            "u1": {"cost": {"flops": 110.0, "bytes_accessed": 60.0},
                   "collectives": {"operand_bytes": 12.0,
                                   "ring_wire_bytes": 24.0}},
            "u2": {"cost": {"flops": 210.0, "bytes_accessed": 110.0},
                   "collectives": {"operand_bytes": 22.0,
                                   "ring_wire_bytes": 44.0}},
        },
    }
    out = tdr.correct(rec, cfg)
    assert out == jdr.correct(rec, jreg.get_config("stablelm-12b"))
    assert out["flops"] == pytest.approx(4 * (10 + 40 * 100))


HLO_SAMPLE = """
  %ar = f32[1024,512]{1,0} all-reduce(%x), replica_groups=[16,16]<=[256], to_apply=%sum
  %ag = bf16[64,4096]{1,0} all-gather(%y), replica_groups={{0,1,2,3}}, dimensions={0}
  %rs = f32[8,128]{1,0} reduce-scatter(%z), replica_groups=[2,8]<=[16], dimensions={0}
  %cp = bf16[32,32]{1,0} collective-permute(%w), source_target_pairs={{0,1},{1,0}}
  %aa = f32[16,16]{1,0} all-to-all(%v), replica_groups=[4,4]<=[16]
  %st = f32[2,2]{1,0} all-reduce-start(%u), replica_groups=[2,2]<=[4]
  %done = f32[4,4]{1,0} add(%a, %b)
"""


def test_parse_collectives_equals_the_reference():
    assert tdr.parse_collectives(HLO_SAMPLE) == \
        jdr.parse_collectives(HLO_SAMPLE)
    assert tdr.parse_collectives(HLO_SAMPLE)["n_collectives"] == 6
    assert tdr.parse_collectives("") == jdr.parse_collectives("")


@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute"])
def test_ring_bytes_is_the_parser_arithmetic(op):
    """The counter's ring model is the parser's: one line of each op over a
    group of 8 parses to what :func:`ring_bytes` gives."""
    groups = ("source_target_pairs={{0,1}}" if op == "collective-permute"
              else "replica_groups=[2,8]<=[16]")
    line = f"  %x = f32[64,32]{{1,0}} {op}(%y), {groups}\n"
    n = 1 if op == "collective-permute" else 8
    operand, wire = tdr.ring_bytes(op, 64 * 32 * 4, n)
    out = jdr.parse_collectives(line)
    assert out["per_op_operand_bytes"] == {op: operand}
    assert out["ring_wire_bytes"] == wire

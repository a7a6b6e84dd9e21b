"""``repro_torch.partition`` and ``repro_torch.launch.mesh`` against the JAX
package's ``partition.py``: twins of ``tests/test_partition_and_dryrun.py``'s
partition tests (the axes predicate, batch-axes divisibility, ``constrain``
a no-op without rules, the rules' spec lookup), the three rule tables key
for key on a (1, 1) mesh, ``Model.param_axes()`` against the reference's
axes tree for every family, the DTensor paths of ``constrain``/``wcast`` on
a one-rank gloo mesh, and the launchers on one and on two gloo ranks."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

import _torch_ranks  # noqa: E402
from repro import partition as rpartition  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.launch.mesh import make_host_mesh as rmake_host_mesh  # noqa: E402
from repro.models.model import Model as RModel  # noqa: E402
from repro_torch import partition  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train.trainer import TrainState  # noqa: E402


class FakeMesh:
    """The reference test's duck-typed 2 x 16 x 16 mesh, in torch's
    ``DeviceMesh`` interface."""
    mesh_dim_names = ("pod", "data", "model")
    shape = (2, 16, 16)

    def __init__(self, coord=(0, 0, 0)):
        self.coord = coord

    def size(self, i=None):
        return int(np.prod(self.shape)) if i is None else self.shape[i]

    def get_local_rank(self, name):
        return self.coord[self.mesh_dim_names.index(name)]


@pytest.fixture
def mesh11(tmp_path):
    """A one-rank gloo group (``file://`` store) and its (1, 1) mesh."""
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
    try:
        yield mesh_mod.make_host_mesh(1, 1, device="cpu")
    finally:
        if started:
            dist.destroy_process_group()


def test_is_axes_leaf_predicate():
    assert partition.is_axes(("embed", "vocab"))
    assert partition.is_axes((None, "model"))
    assert partition.is_axes(())
    assert not partition.is_axes(({"a": 1},))
    assert not partition.is_axes(TrainState(params=1, opt=2, step=3))


def test_batch_axes_divisibility(mesh11):
    assert partition.batch_axes_for(mesh11, 8) == "data"
    assert partition.batch_axes_for(FakeMesh(), 256) == ("pod", "data")
    assert partition.batch_axes_for(FakeMesh(), 16) == "pod"  # 16 % 32 != 0
    assert partition.batch_axes_for(FakeMesh(), 1) is None


def test_constrain_noop_without_rules():
    x = torch.zeros((2, 3))
    assert partition.constrain(x, ("batch", None)) is x
    assert partition.gather(x) is x
    assert partition.wcast(x, torch.float32, ("embed", "ff")) is x
    assert partition.shard_batch(x) is x and partition.mesh_sum(x) is x


def test_constrain_checks_the_rank_under_rules():
    x = torch.zeros((2, 3))
    with partition.use_rules(partition.fsdp_rules(FakeMesh(), 256)):
        assert partition.constrain(x, ("batch", None)) is x  # an activation
        with pytest.raises(ValueError, match="rank 2"):
            partition.constrain(x, ("batch", "seq", "act_embed"))
        with pytest.raises(ValueError, match="rank 2"):
            partition.wcast(x, torch.bfloat16, ("embed",))
    assert partition.current_rules() is None


AXES = [("embed", "ff"), (), ("vocab", "embed"), ("batch", "seq", "act_embed"),
        ("layers", "batch", "cache_seq", None, None),
        ("expert", "embed", "expert_ff"), (None, "inner"), ("heads",),
        ("kv",), ("embed", "kv")]


@pytest.mark.parametrize("table", ["fsdp_rules", "replicated_rules",
                                   "serve_rules"])
def test_tables_and_specs_are_the_references(table, mesh11):
    ref = getattr(rpartition, table)(rmake_host_mesh(1, 1), 8)
    got = getattr(partition, table)(mesh11, 8)
    assert dict(got.table) == dict(ref.table)
    for axes in AXES:
        assert got.spec(axes) == tuple(ref.spec(axes)), axes
    fake = getattr(partition, table)(FakeMesh(), 256)
    assert fake.axis("batch") == ("pod", "data")


def test_rules_spec_lookup(mesh11):
    from torch.distributed.tensor import Replicate, Shard
    rules = partition.fsdp_rules(mesh11, 8)
    assert rules.spec(("embed", "ff")) == ("data", "model")
    assert rules.spec(()) == ()
    assert rules.placements(("embed", "ff")) == (Shard(0), Shard(1))
    assert rules.placements(("ff", "embed")) == (Shard(1), Shard(0))
    assert rules.placements(()) == (Replicate(), Replicate())
    assert rules.sharding(("kv",)) == partition.Sharding(
        mesh11, (Replicate(), Replicate()))
    with pytest.raises(ValueError, match="shards two dims"):
        rules.placements(("heads", "ff"))
    assert rules.size("cache_seq") == 1 and rules.index("batch") == 0


def test_rules_size_and_index_on_a_coordinate():
    rules = partition.fsdp_rules(FakeMesh(coord=(1, 3, 5)), 256)
    assert rules.size("batch") == 32 and rules.index("batch") == 16 + 3
    assert rules.size("cache_seq") == 16 and rules.index("cache_seq") == 5
    assert rules.size("seq") == 1 and rules.index("seq") == 0
    x = torch.arange(64)
    with partition.use_rules(rules):
        assert torch.equal(partition.shard_batch(x), torch.tensor([38, 39]))


def _unstacked(axes, stacks):
    """The reference's axes tree in the port's layout: each stacked group a
    list of per-layer trees without the leading "layers" entry."""
    def strip(tree):
        if isinstance(tree, dict):
            return {k: strip(v) for k, v in tree.items()}
        if rpartition.is_axes(tree):
            assert tree[0] == "layers", tree
            return tree[1:]
        return tuple(strip(v) for v in tree)

    return {k: ([strip(v)] * stacks[k] if k in stacks else v)
            for k, v in axes.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_are_the_references(arch):
    from repro_torch.convert import _stacks
    cfg = get_config(arch).reduced()
    ref = _unstacked(RModel(rget_config(arch).reduced()).param_axes(),
                     _stacks(cfg))
    model = Model(cfg, device="cpu")
    got = model.param_axes()
    assert got == ref
    assert model.param_axes() is got      # built once
    params = model.init(0)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, params)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, got,
                                        is_leaf=partition.is_axes))
    shapes = jax.tree.leaves(jax.tree.map(lambda t: t.ndim, params))
    ranks = jax.tree.leaves(jax.tree.map(len, got,
                                         is_leaf=partition.is_axes))
    assert shapes == ranks


def test_dtensor_constrain_wcast_and_gradient(mesh11):
    from torch.distributed.tensor import Shard, distribute_tensor
    rules = partition.fsdp_rules(mesh11, 8)
    w = torch.randn(8, 6, generator=torch.Generator().manual_seed(0))
    with partition.use_rules(rules):
        (sh,) = jax.tree.leaves(partition.param_shardings(
            rules, {"w": ("embed", "ff")}),
            is_leaf=lambda s: isinstance(s, partition.Sharding))
        wd = partition.place(w, sh).requires_grad_()
        assert tuple(wd.placements) == (Shard(0), Shard(1))
        assert partition.constrain(wd, ("embed", "ff")).placements == \
            wd.placements
        wb = partition.wcast(wd, torch.bfloat16, ("embed", "ff"))
        assert not partition.is_dtensor(wb) and wb.dtype == torch.bfloat16
        assert torch.equal(wb, w.to(torch.bfloat16))
        (wb.float() * 3).sum().backward()
    assert partition.is_dtensor(wd.grad)
    assert wd.grad.placements == wd.placements
    assert torch.equal(wd.grad.full_tensor(), torch.full((8, 6), 3.0))
    assert partition.param_shardings(None, {"w": ("embed",)}) == {"w": None}
    dist_w = distribute_tensor(w, mesh11, list(sh.placements))
    assert torch.equal(partition.gather(dist_w), w)


def test_mesh_needs_enough_ranks(mesh11):
    with pytest.raises(RuntimeError, match="needs 2 ranks, found 1"):
        mesh_mod.make_host_mesh(2, 1, device="cpu")
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        mesh_mod.make_production_mesh(device="cpu")
    assert mesh11.mesh_dim_names == ("data", "model")


def test_process_group_is_left_as_found():
    """Outside torchrun a one-rank group over a HashStore is started for the
    block and destroyed after it; a running one is left alone."""
    running = dist.is_initialized()
    with mesh_mod.process_group("cpu"):
        assert dist.is_initialized()
        with mesh_mod.process_group("cpu"):
            pass
        assert dist.is_initialized()
    assert dist.is_initialized() == running


LAUNCHES = [
    ("train", ["--arch", "h2o-danube-1.8b", "--preset", "smoke", "--steps",
               "3", "--batch", "4", "--seq", "32", "--device", "cpu"]),
    ("serve", ["--arch", "h2o-danube-1.8b", "--preset", "smoke",
               "--requests", "2", "--prompt-len", "12", "--gen", "3",
               "--device", "cpu"]),
]


@pytest.mark.parametrize("which,argv", LAUNCHES)
def test_launchers_alone_bind_no_mesh(which, argv, monkeypatch):
    """One rank runs plain tensors: a launcher binds a mesh only when the
    world has more than one rank."""
    import importlib

    mod = importlib.import_module(f"repro_torch.launch.{which}")

    def no_mesh(*args, **kwargs):
        raise AssertionError("a one-rank launch built a mesh")

    monkeypatch.setattr(mod, "make_host_mesh", no_mesh)
    out = mod.main(argv)
    if which == "train":
        assert out["final_step"] == 3 and all(np.isfinite(out["losses"]))
    else:
        assert out["new_tokens"] == 2 * 3 and out["logits_finite"]


@pytest.mark.parametrize("which,argv", LAUNCHES)
def test_launchers_on_two_ranks(which, argv, tmp_path):
    out = _torch_ranks.run_ranks(_torch_ranks.launch_rank, 2, tmp_path,
                                 which, argv)
    if which == "train":
        assert out[0] == out[1] and out[0]["final_step"] == 3
        assert all(np.isfinite(out[0]["losses"]))
    else:
        assert out[0]["new_tokens"] == out[1]["new_tokens"] == 2 * 3
        assert out[0]["logits_finite"] and out[1]["logits_finite"]

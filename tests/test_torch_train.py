"""The port's training path against the JAX package: ``Model.loss_fn`` and
its gradients for every family (reduced configs, the JAX parameters carried
across by ``convert.model_params_from_arrays``, the same batch from the
same data pipeline), the train step (microbatches, compressed gradients,
loss falling), AdamW's update, the state converters and the launcher.

Bars, loss and gradients against ``jax.value_and_grad`` of the reference's
``loss_fn``: the loss within rel 2e-3 (measured <= 2e-5), the global
gradient norm within rel 2e-2 (measured <= 1.3e-3), and every leaf's
gradient at cosine similarity >= 0.99 with the reference's (measured >=
0.9978, the moe experts' ``wo``).  Both sides compute in bfloat16 with
float32 sums; torch rounds the element-wise work after every op where XLA
may keep float32 inside a fusion, as for the logits
(``tests/test_torch_models.py``), and the gradients of the capacity-routed
experts are the most sensitive to it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RData  # noqa: E402
from repro.models.model import Model as RModel  # noqa: E402
from repro.optim.adamw import AdamW as RAdamW  # noqa: E402
from repro.optim.adamw import cosine_schedule as rcosine  # noqa: E402
from repro.train.trainer import init_state as rinit_state  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (model_params_from_arrays,  # noqa: E402
                                 model_params_to_arrays,
                                 train_state_from_arrays)
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.kernels import adamw as adamw_kernel  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import Model, chunked_cross_entropy  # noqa: E402
from repro_torch.optim.adamw import AdamW, cosine_schedule  # noqa: E402
from repro_torch.train.trainer import (init_state, make_eval_step,  # noqa: E402
                                       make_train_step)

ARCHS = ("h2o-danube-1.8b", "mamba2-370m", "moonshot-v1-16b-a3b",
         "qwen3-moe-30b-a3b", "recurrentgemma-2b", "whisper-base",
         "internvl2-2b")
LOSS_REL, GNORM_REL, LEAF_COS = 2e-3, 2e-2, 0.99


def _jax_pair(arch):
    rm = RModel(rget_config(arch).reduced())
    rparams, _ = rm.init(jax.random.key(0))
    cfg = get_config(arch).reduced()
    return rm, rparams, cfg, model_params_from_arrays(
        cfg, jax.tree.map(np.asarray, rparams), device="cpu")


def _grads(model, params, batch, remat=True):
    leaves, spec = pytree.tree_flatten(params)
    live = [t.detach().clone().requires_grad_() for t in leaves]
    loss, metrics = model.loss_fn(pytree.tree_unflatten(live, spec), batch,
                                  remat=remat)
    grads = torch.autograd.grad(loss, live)
    return loss, metrics, pytree.tree_unflatten(list(grads), spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    rm, rparams, cfg, params = _jax_pair(arch)
    data = RData.for_config(rm.cfg, 64, 2, seed=0, mode="succ").batch(0)
    (rloss, rmet), rgrads = jax.value_and_grad(
        lambda p: rm.loss_fn(p, {k: jnp.asarray(v) for k, v in data.items()}),
        has_aux=True)(rparams)
    model = Model(cfg, device="cpu")
    loss, metrics, grads = _grads(model, params,
                                  {k: torch.as_tensor(v)
                                   for k, v in data.items()})
    assert abs(float(loss) - float(rloss)) <= LOSS_REL * abs(float(rloss))
    assert float(metrics["aux"]) == pytest.approx(float(rmet["aux"]),
                                                  rel=LOSS_REL, abs=1e-6)
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, rgrads))
    got = jax.tree.leaves(model_params_to_arrays(cfg, grads))
    assert len(got) == len(want)

    def norm(leaves):
        return np.sqrt(sum(np.sum(np.square(x.astype(np.float64)))
                           for x in leaves))

    gn_want, gn_got = norm([w for _, w in want]), norm(got)
    assert abs(gn_got - gn_want) <= GNORM_REL * gn_want
    for (path, w), g in zip(want, got):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        w64, g64 = w.astype(np.float64).ravel(), g.astype(np.float64).ravel()
        cos = w64 @ g64 / (np.linalg.norm(w64) * np.linalg.norm(g64))
        assert cos >= LEAF_COS, (jax.tree_util.keystr(path), cos)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "whisper-base",
                                  "recurrentgemma-2b"])
def test_remat_changes_no_gradient(arch):
    """Per-layer checkpointing recomputes the same forward: the gradients
    with and without it are equal."""
    _, _, cfg, params = _jax_pair(arch)
    model = Model(cfg, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLMData.for_config(
        cfg, 32, 2, mode="succ").batch(0).items()}
    l1, _, g1 = _grads(model, params, batch, remat=True)
    l0, _, g0 = _grads(model, params, batch, remat=False)
    assert torch.equal(l1, l0)
    for a, b in zip(pytree.tree_leaves(g1), pytree.tree_leaves(g0)):
        assert torch.equal(a, b)


def test_chunked_cross_entropy_equals_the_whole_logits():
    """The chunked CE equals ``softmax_cross_entropy`` of ``unembed`` over
    the whole sequence, the pad logits masked, with and without a mask."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 48, 16)).astype(
        np.float32)).to(layers.COMPUTE_DTYPE)
    head = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 50, (2, 48)))
    mask = torch.from_numpy((rng.random((2, 48)) < 0.7).astype(np.float32))
    logits = layers.unembed(x, head)
    logits = torch.where(torch.arange(64) >= 50, -1e30, logits)
    for m in (None, mask):
        want = layers.softmax_cross_entropy(logits, labels, m)
        got = chunked_cross_entropy(x, head, labels, m, chunk=16,
                                    valid_vocab=50)
        assert float(got) == pytest.approx(float(want), rel=1e-6)


def _stablelm():
    return Model(get_config("stablelm-12b").reduced(), device="cpu")


def _batch(model, B=8, S=32, step=0, mode="succ"):
    return SyntheticLMData.for_config(model.cfg, S, B, mode=mode).batch(step)


def test_grad_accumulation_matches_single_batch():
    """The reference's test_grad_accumulation_matches_single_batch on the
    port: four strided microbatches give the single batch's loss and
    gradient norm, and parameters within Adam's ~2 lr of each other."""
    model = _stablelm()
    opt = AdamW(learning_rate=1e-3)
    batch = _batch(model)
    n1, m1 = make_train_step(model, opt)(init_state(model, opt, 0), batch)
    n4, m4 = make_train_step(model, opt, microbatches=4)(
        init_state(model, opt, 0), batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-3)
    assert float(m1["grad_norm"]) == pytest.approx(float(m4["grad_norm"]),
                                                   rel=1e-3)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        pytree.tree_leaves(n1.params), pytree.tree_leaves(n4.params)))
    assert diff < 3.0 * 1e-3
    assert int(n1.step) == int(n4.step) == 1


@pytest.mark.parametrize("compress,mode,steps,drop", [
    (False, "succ", 30, 0.5), (True, "succ", 25, 0.3)])
def test_training_reduces_loss(compress, mode, steps, drop):
    """The reference's test_training_reduces_loss_on_copy_task (which trains
    on succ) and test_compressed_grads_still_learn on the port."""
    model = _stablelm()
    opt = AdamW(learning_rate=3e-3)
    state = init_state(model, opt, 0)
    step = make_train_step(model, opt, compress_grads=compress)
    data = SyntheticLMData.for_config(model.cfg, 64, 8, mode=mode)
    losses = []
    for i in range(steps):
        state, m = step(state, data.batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - drop, losses
    assert ("quant_err" in m) == compress


def test_eval_step_is_the_loss_without_gradients():
    model = _stablelm()
    opt = AdamW()
    state = init_state(model, opt, 0)
    batch = _batch(model)
    ev = make_eval_step(model)(state.params, batch)
    loss, _ = model.loss_fn(state.params, {k: torch.as_tensor(v)
                                           for k, v in batch.items()})
    assert float(ev["loss"]) == pytest.approx(float(loss), rel=1e-6)
    assert not ev["loss"].requires_grad


def test_adamw_update_matches_reference():
    """One AdamW update (warmup + cosine schedule, clipping, weight decay)
    on the same parameters, moments and gradients: every new parameter and
    moment within 1e-6 of the largest of its leaf (float32 arithmetic in
    the same order; XLA and torch may round a cos, pow or sqrt an ulp
    apart, which moves an element near zero by more than 1e-6 of itself)."""
    arch = "h2o-danube-1.8b"
    rm = RModel(rget_config(arch).reduced())
    ropt = RAdamW(learning_rate=rcosine(1e-2, 3, 10), clip_norm=1.0)
    rstate = rinit_state(rm, ropt, jax.random.key(0))
    rng = np.random.default_rng(0)
    noise = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), rstate.params)
    rstate = rstate._replace(opt=rstate.opt._replace(
        m=jax.tree.map(lambda n: jnp.asarray(0.01 * n), noise),
        v=jax.tree.map(lambda n: jnp.asarray(1e-4 * n * n), noise),
        count=jnp.asarray(4, jnp.int32)))
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), rstate.params)
    rnew, ropt_state, rmet = ropt.update(
        jax.tree.map(jnp.asarray, grads), rstate.opt, rstate.params)

    cfg = get_config(arch).reduced()
    state = train_state_from_arrays(cfg, jax.tree.map(np.asarray, rstate),
                                    device="cpu")
    opt = AdamW(learning_rate=cosine_schedule(1e-2, 3, 10), clip_norm=1.0)
    grads = model_params_from_arrays(cfg, grads, device="cpu")
    new, opt_state, met = opt.update(grads, state.opt, state.params)
    assert float(met["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]),
                                                    rel=1e-6)
    assert float(met["lr"]) == pytest.approx(float(rmet["lr"]), rel=1e-6)
    assert int(opt_state.count) == int(ropt_state.count) == 5
    for got_tree, want_tree in ((new, rnew), (opt_state.m, ropt_state.m),
                                (opt_state.v, ropt_state.v)):
        got = jax.tree.leaves(model_params_to_arrays(cfg, got_tree))
        want = jax.tree.leaves(jax.tree.map(np.asarray, want_tree))
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()


def _mixed_sizes(n_leaves: int, chunk: int) -> list:
    """``n_leaves`` sizes drawn around ``chunk``: empty leaves, single
    elements, counts that are no multiple of 4, whole and ragged chunks."""
    rng = np.random.default_rng(n_leaves)
    picks = (0, 1, 3, chunk - 1, chunk, chunk + 1, 4 * chunk + 5)
    return [int(rng.choice(picks)) if rng.random() < 0.5
            else int(rng.integers(0, 5 * chunk)) for _ in range(n_leaves)]


@pytest.mark.parametrize("chunk", [adamw_kernel.CHUNK, 64])
@pytest.mark.parametrize("n_leaves", [1, 2, 37, 500])
def test_chunk_table_covers_every_element_once(n_leaves, chunk):
    """The kernel's chunk table (a pure function of the leaves' sizes) and
    its chunk-to-leaf search: every element of every leaf in exactly one
    chunk, no chunk for an empty leaf, none longer than ``chunk``."""
    sizes = _mixed_sizes(n_leaves, chunk)
    if n_leaves == 1:
        sizes = [2 * chunk + 3]
    first = adamw_kernel.chunk_table(sizes, chunk)
    assert first[0] == 0 and len(first) == n_leaves + 1
    spans = {}
    for c in range(int(first[-1])):
        leaf, start, count = adamw_kernel.chunk_span(first, sizes, c, chunk)
        assert 0 < count <= chunk and start % chunk == 0
        spans.setdefault(leaf, []).append((start, count))
    for leaf, size in enumerate(sizes):
        covered = 0
        for start, count in sorted(spans.get(leaf, [])):
            assert start == covered
            covered += count
        assert covered == size
    assert all(sizes[leaf] > 0 for leaf in spans)


class _OpNames(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the name of every operator dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_adamw_traces_the_kernel_op_under_fake_tensors():
    """On fake CUDA tensors (the dry-run), ``AdamW.update`` calls the
    kernel's ops, launches nothing and takes none of the plain loop's
    per-leaf arithmetic; every leaf keeps its shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = adamw_kernel.launches()
    shapes = [(5, 7), (3,), (0,), (2, 4, 8)]
    opt = AdamW(learning_rate=cosine_schedule(1e-2, 3, 10), clip_norm=1.0)
    with FakeTensorMode():
        params = [torch.empty(s, device="cuda") for s in shapes]
        grads = [torch.empty(s, device="cuda") for s in shapes]
        state = opt.init(params)
        with _OpNames() as ops:
            new, new_state, met = opt.update(grads, state, params)
    assert adamw_kernel.launches() == before
    assert ops.names.count("repro_torch.adamw_sq_norms.default") == 1
    assert ops.names.count("repro_torch.adamw_update.default") == 1
    # The plain loop writes each leaf's m, v and p with ``copy_``.
    assert "aten.copy_.default" not in ops.names, ops.names
    for tree in (new, new_state.m, new_state.v):
        assert [(tuple(t.shape), t.dtype) for t in tree] == [
            (s, torch.float32) for s in shapes]
    assert new_state.count.dtype == torch.int32
    assert met["grad_norm"].shape == () and met["lr"].shape == ()


@pytest.mark.parametrize("bad", ["p bf16", "m transposed", "v short",
                                 "g transposed"])
def test_adamw_kernel_wrappers_refuse_what_the_kernel_does_not_take(bad):
    """p, m and v must be contiguous float32 leaves of g's sizes (checked
    on ``meta`` tensors, which the ops take without a card); a
    non-contiguous gradient is refused by the wrappers and copied, and
    counted, by ``contiguous_grads``."""
    def leaves():
        return [torch.empty((4, 6), device="meta"),
                torch.empty((5,), device="meta")]

    g, p, m, v = leaves(), leaves(), leaves(), leaves()
    name, how = bad.split()
    tree = {"g": g, "p": p, "m": m, "v": v}[name]
    tree[0] = {"bf16": tree[0].bfloat16(), "transposed": tree[0].t(),
               "short": tree[0][:3]}[how]
    scalars = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match=f"{name}\\[0\\] must be a "
                                         "contiguous float32"):
        adamw_kernel.update_cuda(g, p, m, v, scalars, b1=0.9, b2=0.95,
                                 eps=1e-8, wd=0.1)
    if name == "g":
        with pytest.raises(ValueError, match="must be a contiguous"):
            adamw_kernel.sq_norms_cuda(g)
        copies = adamw_kernel.contiguous_grads.copies
        dense = adamw_kernel.contiguous_grads(g)
        assert adamw_kernel.contiguous_grads.copies == copies + 1
        assert dense[0].is_contiguous() and dense[1] is g[1]
        assert adamw_kernel.sq_norms_cuda(dense).shape == (2,)


def test_adamw_on_the_cpu_never_loads_the_kernel(monkeypatch):
    """CPU tensors take the plain loop: the kernel's library is never
    built or loaded, and nothing is counted."""
    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(adamw_kernel.build, "load", refuse)
    before = adamw_kernel.launches()
    opt = AdamW(learning_rate=1e-2)
    params = [torch.ones(3, 5), torch.ones(7)]
    state = opt.init(params)
    new, _, met = opt.update([torch.full((3, 5), 0.5), torch.ones(7)],
                             state, params)
    assert adamw_kernel.launches() == before
    assert float(met["grad_norm"]) == pytest.approx(np.sqrt(15 * 0.25 + 7))
    assert all(bool((p < 1).all()) for p in new)


@pytest.mark.card
def test_adamw_kernel_is_bit_equal_to_the_plain_loop_on_the_card():
    """On the card: three updates of a small mixed set of leaves (empty,
    odd sizes, a 16-byte misaligned view) through the kernel and through
    the plain loop with the same scalars, p, m and v bit-equal; the
    per-leaf norms within 2e-6 of ``torch.sum``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sizes = (1, 3, 0, 4097, adamw_kernel.CHUNK + 5, 640)
    base = torch.randn(sizes[-1] + 1, generator=gen, device=dev)

    def leaves(scale):
        out = [scale * torch.randn(n, generator=gen, device=dev)
               for n in sizes[:-1]]
        return out + [scale * base[1:]]   # 4 bytes past an aligned base

    p, m, g = leaves(0.02), leaves(1e-2), leaves(1e-3)
    v = [torch.square(t) for t in leaves(1e-2)]
    pp, mp, vp = ([t.clone() for t in ts] for ts in (p, m, v))
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    launches = adamw_kernel.launches()
    for t in (1, 2, 3):
        scalars = torch.tensor([0.5, 1e-3 * t, 1 - 0.9 ** t, 1 - 0.95 ** t],
                               dtype=torch.float32, device=dev)
        adamw_kernel.update_cuda(g, p, m, v, scalars, **hyper)
        adamw_kernel.update_plain(g, pp, mp, vp, scalars[0], scalars[1],
                                  scalars[2], scalars[3], **hyper)
    sq = adamw_kernel.sq_norms_cuda(g)
    torch.cuda.synchronize()
    assert adamw_kernel.launches() - launches == 3 + 2
    for a, b in zip(p + m + v, pp + mp + vp):
        assert torch.equal(a, b)
    want = torch.stack(adamw_kernel.sq_norms_plain(g))
    assert torch.allclose(sq, want, rtol=2e-6, atol=0)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-base",
                                  "mamba2-370m"])
def test_params_round_trip_through_the_reference_layout(arch):
    rm, rparams, cfg, params = _jax_pair(arch)
    back = model_params_to_arrays(cfg, params)
    want = jax.tree.map(np.asarray, rparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --preset smoke --device cpu``:
    a few steps with a checkpoint, loss falling on succ, the summary line
    printed."""
    out = launch_train.main([
        "--arch", "h2o-danube-1.8b", "--preset", "smoke", "--steps", "12",
        "--batch", "4", "--seq", "32", "--lr", "3e-3", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "5"])
    assert out["final_step"] == 12 and out["recoveries"] == 0
    assert out["losses"][-1] < out["losses"][0]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir())[-1] == \
        "step_000011"
    assert '"device": "cpu"' in capsys.readouterr().out


def test_launcher_presets_are_the_references():
    from repro.launch.train import preset_config as rpreset
    for arch in ("stablelm-12b", "mamba2-370m", "qwen3-moe-30b-a3b"):
        for preset in ("smoke", "100m", "full"):
            got = launch_train.preset_config(arch, preset)
            want = rpreset(arch, preset)
            assert got.name == want.name
            assert got.param_count() == want.param_count()

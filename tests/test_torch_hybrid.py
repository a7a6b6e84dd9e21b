"""granite-4.0-h-micro on the port: a Mamba-2 + full-attention hybrid, the
one architecture of the port with no JAX twin.  The port's training loss,
gradients and served logits against the benchmark's plain float32
reference (``bench/reference/ssm_hybrid.py``) at reduced width on seeded
weights; the two kinds of decode state side by side; the attention's own
softmax scale through the kernels' ops and autograd; spans by layer kind;
the dry-run's cells."""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from bench.common import weights  # noqa: E402
from bench.reference import ssm_hybrid  # noqa: E402
from bench.reference.common import FP32, Prec, cross_entropy  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.config import PORT_FIELDS, ModelConfig  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

torch.set_num_threads(2)

ARCH = "granite-4.0-h-micro"
CFG = registry.get_config(ARCH).reduced()
M = dataclasses.asdict(CFG)
SEEDS = (1, 2, 3)


def _batch(seed, B=2, S=64):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, CFG.vocab_size, (B, S), generator=gen)
    return tokens, torch.roll(tokens, -1, dims=1)


def _grads(seed, loss_of):
    """(loss, gradients in ``param_specs`` order) on the benchmark's weights
    from ``seed``, the tree in the program's layout."""
    specs = ssm_hybrid.param_specs(M)
    _, leaves = weights.make(specs, seed, "cpu")
    live = [t.detach().requires_grad_() for t in leaves]
    loss = loss_of(weights.tree_of([p for p, _, _ in specs], live))
    return loss.detach(), torch.autograd.grad(loss, live)


def _port_loss(tokens, labels, remat=True):
    model = Model(CFG, device="cpu")
    return lambda P: model.loss_fn(P, {"tokens": tokens, "labels": labels},
                                   remat=remat)[0]


def _ref_loss(tokens, labels, prec):
    def loss(P):
        x = ssm_hybrid.hidden(P, tokens, M, prec, train=True)
        return cross_entropy(x.reshape(-1, x.shape[-1]),
                             ssm_hybrid.head(P, M), labels.reshape(-1), prec)
    return loss


def _worst_leaf(got, want) -> float:
    """The worst leaf's |got - want| norm over the larger of its reference
    norm and the median leaf's (``bench/common/compare.py``'s measure)."""
    med = torch.stack([w.norm() for w in want]).median()
    return max(float((g - w).norm() / torch.clamp(w.norm(), min=med))
               for g, w in zip(got, want))


def test_the_config_is_the_published_one():
    body = json.loads((ROOT / "bench/configs/granite-4.0-h-micro.json")
                      .read_text())
    pub, cfg = body["published"], registry.get_config(ARCH)
    assert ARCH in registry.PORT_ONLY_ARCHS and ARCH not in registry.ARCHS
    assert ModelConfig(**body["model"]) == cfg
    kinds = ["attn" if t == "attention" else t for t in pub["layer_types"]]
    assert list(cfg.block_types()) == kinds and cfg.n_layers % 10 == 0
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            cfg.d_ff, cfg.vocab_size, cfg.ssm_state, cfg.n_ssm_heads,
            cfg.ssm_head_dim, cfg.conv_width, cfg.ssm_chunk) == (
        pub["hidden_size"], pub["num_attention_heads"],
        pub["num_key_value_heads"], 64, pub["shared_intermediate_size"],
        pub["vocab_size"], pub["mamba_d_state"], pub["mamba_n_heads"],
        pub["mamba_d_head"], pub["mamba_d_conv"], pub["mamba_chunk_size"])
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.attention_multiplier, cfg.logits_scaling) == (
        pub["embedding_multiplier"], pub["residual_multiplier"],
        pub["attention_multiplier"], pub["logits_scaling"])
    assert cfg.position_embedding == pub["position_embedding_type"] == "nope"
    assert cfg.local_window is None and cfg.tie_embeddings
    # Matrices only, as every family counts them: 36 x 25.84M of Mamba-2,
    # 4 x 10.49M of attention, 40 x 50.33M of MLP, 205.5M of embedding.
    assert cfg.param_count() == (36 * 25_838_592 + 4 * 10_485_760
                                 + 40 * 50_331_648 + 205_520_896)


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_the_twins_keep_the_neutral_port_fields(arch):
    cfg = registry.get_config(arch)
    assert {k: getattr(cfg, k) for k in PORT_FIELDS} == PORT_FIELDS


@pytest.mark.parametrize("seed", SEEDS)
def test_training_matches_the_reference(seed):
    """Loss and every leaf's gradient against the float32 reference on the
    same weights and rows.  The port computes in bf16 (matmul operands and
    every activation, the residual stream included): the worst leaf's
    gradient reads 1.19e-2 to 1.26e-2 of its norm over seeds 1-3, so the
    limit is 3e-2; the reference in float8 (``Prec("fp8")``) reads 0.11 to
    0.14, outside it.  The loss sits near ln(vocab) (the logits are divided
    by 8) and moves by 4e-6 of itself at most: 1e-4."""
    tokens, labels = _batch(seed)
    lp, gp = _grads(seed, _port_loss(tokens, labels))
    lr, gr = _grads(seed, _ref_loss(tokens, labels, FP32))
    _, gc = _grads(seed, _ref_loss(tokens, labels, Prec("fp8")))
    assert abs(float((lp - lr) / lr)) <= 1e-4
    assert _worst_leaf(gp, gr) <= 3e-2 < _worst_leaf(gc, gr)


def test_multipliers_are_part_of_the_match():
    """The same comparison with one multiplier of the port's own at its
    neutral value fails the 3e-2 tolerance: each is computed.  Worst leaf
    at seed 1: the embedding's multiplier 1.0 12.8, the residual's 3.78,
    the scale dh ** -0.5 0.068, no logits' divisor 7.81.  (Rotary
    positions hide in these weights' near-uniform attention, 1.2e-2: the
    next test shows them.)"""
    tokens, labels = _batch(1)
    _, gr = _grads(1, _ref_loss(tokens, labels, FP32))
    for field in ("embedding_multiplier", "residual_multiplier",
                  "attention_multiplier", "logits_scaling"):
        cfg = dataclasses.replace(CFG, **{field: PORT_FIELDS[field]})
        model = Model(cfg, device="cpu")
        _, gp = _grads(1, lambda P: model.loss_fn(
            P, {"tokens": tokens, "labels": labels})[0])
        assert _worst_leaf(gp, gr) > 3e-2, field


def test_attention_block_matches_the_reference():
    """The attention block alone on weights large enough that its scores
    matter (std 0.5): no position embedding and the scale 1/64, against
    the reference's block in float32; the port's bf16 output reads
    3.2e-3 of the reference's max (bf16 operands), with rotary positions
    0.46."""
    from repro_torch.models import attention as attn_lib
    gen = torch.Generator().manual_seed(0)
    d, q, kv = CFG.d_model, CFG.q_dim, CFG.kv_dim
    p = {name: 0.5 * torch.randn(shape, generator=gen) for name, shape in
         (("wq", (d, q)), ("wk", (d, kv)), ("wv", (d, kv)), ("wo", (q, d)))}
    x = torch.randn(2, 40, d, generator=gen)
    want = ssm_hybrid._attention(p, x, M, FP32, False)

    def port(cfg):
        out = attn_lib.attention(p, x.to(torch.bfloat16), cfg,
                                 positions=torch.arange(40)[None],
                                 window=cfg.local_window)
        return float((out.float() - want).abs().max() / want.abs().max())

    assert port(CFG) <= 3e-2 < port(dataclasses.replace(
        CFG, position_embedding="rope"))


def test_remat_changes_no_gradient():
    """Per-layer checkpointing (a hybrid's too) recomputes the same
    forward: the gradients with and without it are equal."""
    tokens, labels = _batch(4)
    l1, g1 = _grads(4, _port_loss(tokens, labels, remat=True))
    l0, g0 = _grads(4, _port_loss(tokens, labels, remat=False))
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_then_decode_matches_the_reference(seed):
    """A prefill, then three decode steps through the cache's two kinds of
    state, each step's logits against the reference's full forward over
    the same tokens (``chip_smoke.reference_gaps``, which the card runs at
    full width): max |served - reference| over max |reference|.  The gap is
    bf16's rounding of every activation and weight compounded through the
    10 layers: 2.4e-3 to 3.6e-3 over seeds 1-3, so 1.2e-2."""
    model = Model(CFG, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(1, CFG.vocab_size, (2, 40), generator=gen)
    gaps = chip_smoke.reference_gaps(torch, model, model.init(seed), seed,
                                     toks, CFG.vocab_size, "ssm_hybrid")
    assert len(gaps) == chip_smoke.CONSIST_STEPS and max(gaps) <= 1.2e-2


def test_the_cache_holds_both_kinds_of_state():
    model = Model(CFG, device="cpu")
    cache = model.init_cache(3, 50)
    units = cache["units"]
    assert cache["rem"] == ()
    for kind, st in zip(CFG.block_pattern, units):
        if kind == "mamba":
            assert set(st) == {"conv", "ssm"}
            assert st["ssm"].shape == (1, 3, CFG.n_ssm_heads,
                                       CFG.ssm_head_dim, CFG.ssm_state)
            assert st["ssm"].dtype == torch.float32
        else:   # full attention: a slot for every position
            assert set(st) == {"k", "v"}
            assert st["k"].shape == (1, 3, 50, CFG.n_kv_heads, CFG.head_dim_)
    kv, state = model.cache_bytes(cache)
    assert kv == 2 * 3 * 50 * CFG.n_kv_heads * CFG.head_dim_ * 2
    conv = (CFG.conv_width - 1) * (CFG.d_inner + 2 * CFG.ssm_state) * 2
    ssm = CFG.n_ssm_heads * CFG.ssm_head_dim * CFG.ssm_state * 4
    assert state == 9 * 3 * (conv + ssm)


def test_decode_reads_keys_past_any_window():
    """Full attention: the prefill keeps every position's key in the cache
    (no 32-key window, the reduced config's default), and a decode step at
    position 69 equals the prefill of the whole prefix."""
    model = Model(CFG, device="cpu")
    params = model.init(0)
    toks = torch.randint(1, CFG.vocab_size, (2, 70),
                         generator=torch.Generator().manual_seed(0))
    _, cache = model.prefill(params, {"tokens": toks[:, :69]}, max_seq=80)
    got, _ = model.decode_step(params, cache, toks[:, 69], 69)
    want, _ = model.prefill(params, {"tokens": toks}, max_seq=80)
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()
    # Every prefilled position holds its key, at its own slot.
    k = cache["units"][CFG.block_pattern.index("attn")]["k"]
    assert bool((k[:, :, :69] != 0).any(-1).any(-1).all())
    assert not bool(k[:, :, 70:].any())


def test_spans_split_a_step_by_layer_kind():
    """``model.layer`` carries ``kind``; a Mamba-2 layer runs under
    ``model.ssm`` with its three inner spans, an attention layer under
    ``model.attention``; a prefill's span counts both kinds of cache."""
    model = Model(CFG, device="cpu")
    params = model.init(0)
    srv = serve.Server(model, params, 2, max_seq=24, device="cpu")
    reqs = [serve.Request(rid=i, prompt=np.arange(1, 9) + i, max_new=2)
            for i in range(2)]
    tokens, labels = _batch(0, S=16)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        model.loss_fn(params, {"tokens": tokens, "labels": labels})
        srv.run(reqs)
    recs = spans.records()
    layers = [r for r in recs if r.name == "model.layer"]
    kinds = {r.attrs["layer"]: r.attrs["kind"] for r in layers}
    assert kinds == dict(enumerate(CFG.block_types()))
    for r in recs:
        if r.parent is not None and r.parent.name == "model.layer":
            inner = {"model.ssm"} if r.parent.attrs["kind"] == "mamba" \
                else {"model.attention"}
            assert r.name in inner | {"model.norm", "model.mlp"}
    ssm_inner = {r.name for r in recs if r.parent is not None
                 and r.parent.name == "model.ssm"}
    assert ssm_inner == {"ssm.conv", "ssm.scan", "ssm.gate_norm"}
    (prefill,) = [r for r in recs if r.name == "serve.prefill"]
    kv, state = model.cache_bytes(model.init_cache(2, 24))
    assert (prefill.attrs["kv_bytes"], prefill.attrs["state_bytes"]) == (
        kv, state) and kv > 0 and state > 0


def test_attention_scale_through_the_autograd_function(monkeypatch):
    """``FlashAttention`` hands its ``scale`` to both ops: with the two
    wrappers standing on the plain versions, its output and gradients
    equal autograd's through ``flash_attention_plain`` at that scale, and
    differ from the default scale's."""
    seen = []

    def fwd(q, k, v, *, causal, window=None, prefix=0, return_lse=False,
            scale=None):
        seen.append(("fwd", scale))
        return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        bidirectional_prefix=prefix,
                                        scale=scale, return_lse=return_lse)

    def bwd(q, k, v, o, lse, do, *, causal, window=None, prefix=0,
            scale=None):
        seen.append(("bwd", scale))
        return fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            causal=causal, window=window,
                                            bidirectional_prefix=prefix,
                                            scale=scale)

    monkeypatch.setattr(fa, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", bwd)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 40, h, 64, generator=gen, dtype=torch.float64)
               for h in (4, 2, 2))
    do = torch.randn(2, 40, 4, 64, generator=gen, dtype=torch.float64)

    def run(fn, scale):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, scale)
        return (out, *torch.autograd.grad(out, leaves, do))

    got = run(lambda q, k, v, s: fa.FlashAttention.apply(q, k, v, True, None,
                                                         0, s), 1 / 64)
    want = run(lambda q, k, v, s: fa.flash_attention_plain(
        q, k, v, causal=True, scale=s), 1 / 64)
    other = run(lambda q, k, v, s: fa.flash_attention_plain(
        q, k, v, causal=True, scale=s), None)
    assert seen == [("fwd", 1 / 64), ("bwd", 1 / 64)]
    # The plain versions sum their products in float32.
    for g, w, o in zip(got, want, other):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        assert not torch.allclose(g, o, rtol=1e-2, atol=1e-3)


def test_attention_ops_take_a_scale_in_their_schema():
    """Both ops take ``scale`` last, None by default, and their fake
    implementations give the same outputs with and without it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = "cuda" if torch.backends.cuda.is_built() else "meta"
    for op in (torch.ops.repro_torch.flash_attention,
               torch.ops.repro_torch.flash_attention_bwd):
        arg = op.default._schema.arguments[-1]
        assert (arg.name, str(arg.type), arg.default_value) == (
            "scale", "Optional[float]", None)
    with FakeTensorMode():
        q = torch.empty(1, 48, 4, 64, dtype=torch.bfloat16,
                        device=fake)
        k = torch.empty(1, 48, 2, 64, dtype=torch.bfloat16,
                        device=fake)
        o, lse = fa.flash_attention_cuda(q, k, k, causal=True,
                                         return_lse=True, scale=1 / 64)
        grads = fa.flash_attention_bwd_cuda(q, k, k, o, lse, o, causal=True,
                                            scale=1 / 64)
        plain = fa.flash_attention_cuda(q, k, k, causal=True)
    assert o.shape == plain.shape == q.shape and lse.shape == (1, 4, 48)
    assert [t.shape for t in grads] == [q.shape, k.shape, k.shape]


@pytest.mark.card
def test_attention_kernels_take_the_scale_on_the_card():
    """On the card: the forward and backward kernels at granite's dh 64 and
    scale 1/64 against their plain versions, at the kernel tests' bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, do = (torch.randn(1, 300, 8, 64, generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(1, 300, 2, 64, generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    o, lse = fa.flash_attention_cuda(q, k, v, causal=True, return_lse=True,
                                     scale=1 / 64)
    po, plse = fa.flash_attention_plain(q, k, v, causal=True, scale=1 / 64,
                                        return_lse=True)
    assert chip_smoke.norm_err(o, po) <= chip_smoke.ATTN_BAR
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True,
                                      scale=1 / 64)
    want = fa.flash_attention_bwd_plain(q, k, v, po, plse, do, causal=True,
                                        scale=1 / 64)
    for g, w in zip(got, want):
        assert chip_smoke.norm_err(g, w) <= chip_smoke.ATTN_BAR


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_dryrun_cells(shape):
    """The architecture's three dry-run cells (``long_500k`` is skipped:
    its attention is quadratic) at reduced width on a 2 x 2 fake mesh:
    each model rank computes its share of the Mamba-2 heads, the attention
    heads, the ff columns and the vocab, so no block repeats."""
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import fake_mesh
    assert [s for s in registry.SHAPES
            if registry.cell_skip_reason(ARCH, s) is None] == [
        "train_4k", "prefill_32k", "decode_32k"]
    with fake_mesh((2, 2)) as mesh:
        tr, meta = dr.trace_cell(ARCH, shape, mesh, cfg=CFG, batch_rows=4,
                                 microbatches=1)
        cap = dr.capture(tr)
    assert cap["cost"]["flops"] > 0 and meta["repeated_blocks"] == {}
    assert cap["collectives"]["per_op_operand_bytes"]["all-reduce"] > 0


def test_the_benchmark_weights_have_the_ports_layout():
    """``param_specs`` lays out the port's tree, its units lists where the
    port's are tuples."""
    specs = ssm_hybrid.param_specs(M)
    ours = weights.tree_of([p for p, _, _ in specs],
                           [torch.empty(s, device="meta") for _, s, _ in specs])
    port = Model(CFG, device="meta").param_shapes()
    port["layers"] = [list(unit) for unit in port["layers"]]
    flat = pytree.tree_flatten
    assert flat(ours)[1] == flat(port)[1]
    assert [t.shape for t in flat(ours)[0]] == [t.shape for t in flat(port)[0]]

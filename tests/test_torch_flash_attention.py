"""The ``flash_attention`` kernel's plain torch version against the JAX
package: its Pallas kernel (interpret mode, through ``repro.kernels.ops``,
which pads dh to 128), its dense oracle ``ref.attention_ref`` and the
model's ``blockwise_attention`` in the model layout.

Bars: ``tests/test_kernels.py``'s, atol 2e-3 in float32 and 3e-2 in
bfloat16 (measured: <= 2e-6 and <= 1.6e-2, one bf16 ulp of outputs near
2-4).  Against ``blockwise_attention`` in bfloat16, the same algorithm with
the same roundings: atol 1e-2 (measured <= 3.9e-3, one bf16 ulp of
outputs near 2-4: the rounding of the output may land either way after
float32 sums taken in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(seed, B, H, KV, S, dh, layout="jax"):
    """q, k, v as float32 numpy from a seeded generator, in the JAX layout
    [B, heads, S, dh] or the model layout [B, S, heads, dh]."""
    rng = np.random.default_rng(seed)
    shapes = [(B, H, S, dh), (B, KV, S, dh), (B, KV, S, dh)]
    if layout == "model":
        shapes = [(b, s, h, d) for b, h, s, d in shapes]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,H,KV,S,dh", [
    (1, 2, 2, 128, 64),
    (2, 4, 2, 256, 64),
    (1, 8, 8, 384, 128),
    (2, 4, 1, 256, 80),     # MQA + a head dim the Pallas wrapper pads
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_and_oracles(B, H, KV, S, dh, dtype):
    arrays = _inputs(S + dh, B, H, KV, S, dh)
    (jq, jk, jv), (q, k, v) = _both(arrays, dtype)
    tol = DTYPES[dtype][2]
    got = _f32(ops.flash_attention(q, k, v, causal=True, device="cpu"))
    pallas = _f32(rops.flash_attention(jq, jk, jv, causal=True))
    np.testing.assert_allclose(got, pallas, atol=tol)
    np.testing.assert_allclose(got, _f32(rref.attention_ref(jq, jk, jv)),
                               atol=tol)
    np.testing.assert_allclose(got, _f32(ref.attention_ref(q, k, v)),
                               atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("chunk", [64, 1024])
def test_ragged_length_head_dim_80_gqa(dtype, chunk):
    """S = 200 is no multiple of the Pallas kernel's 128 (it asserts one);
    the plain version pads and masks, the CUDA kernel masks the edge."""
    B, H, KV, S, dh = 1, 4, 2, 200, 80
    arrays = _inputs(7, B, H, KV, S, dh)
    (jq, jk, jv), (q, k, v) = _both(arrays, dtype)
    got = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=True,
                                   chunk=chunk).transpose(1, 2)
    np.testing.assert_allclose(_f32(got),
                               _f32(rref.attention_ref(jq, jk, jv)),
                               atol=DTYPES[dtype][2])


@pytest.mark.parametrize("window", [64, 128])
def test_sliding_window(window):
    B, H, KV, S, dh = 1, 4, 2, 256, 64
    (jq, jk, jv), (q, k, v) = _both(_inputs(window, B, H, KV, S, dh), "f32")
    got = _f32(ops.flash_attention(q, k, v, causal=True, window=window,
                                   device="cpu"))
    np.testing.assert_allclose(
        got, _f32(rops.flash_attention(jq, jk, jv, causal=True,
                                       window=window)), atol=2e-3)
    np.testing.assert_allclose(
        got, _f32(ref.attention_ref(q, k, v, causal=True, window=window)),
        atol=2e-3)


def test_noncausal():
    B, H, KV, S, dh = 2, 2, 2, 128, 64
    (jq, jk, jv), (q, k, v) = _both(_inputs(3, B, H, KV, S, dh), "f32")
    got = _f32(ops.flash_attention(q, k, v, causal=False, device="cpu"))
    np.testing.assert_allclose(
        got, _f32(rops.flash_attention(jq, jk, jv, causal=False)), atol=2e-3)
    np.testing.assert_allclose(
        got, _f32(rref.attention_ref(jq, jk, jv, causal=False)), atol=2e-3)


# (S, chunk, window, causal, H, KV, dh): danube's head dim 80 first, then
# the head dims of the configs still to be served, which the card checks too.
MODEL_LAYOUT_CASES = [
    (256, 64, None, True, 4, 2, 80),
    (256, 64, 96, True, 4, 2, 80),
    (211, 64, None, True, 4, 2, 80),    # no divisor in (32, 64]: padded keys
    (211, 64, 50, True, 4, 2, 80),
    (130, 1024, None, False, 4, 2, 80),
    (200, 128, 64, True, 4, 2, 80),     # chunk 100, window across chunks
] + [(S, chunk, window, causal, H, KV, dh)
     for dh in (64, 128)
     for S, chunk, window, causal, H, KV in [
         (200, 128, 100, True, 4, 1),   # ragged, GQA x4, window across chunks
         (211, 64, None, True, 4, 4),   # whisper-base's heads: one per kv head
         (256, 64, 50, True, 8, 2),
         (130, 1024, None, False, 2, 2)]]


def _case_id(case):
    S, chunk, window, causal, H, KV, dh = case
    base = f"{S}-{chunk}-{window}-{causal}"
    return base if dh == 80 else f"{base}-dh{dh}-h{H}kv{KV}"


@pytest.mark.parametrize("S,chunk,window,causal,H,KV,dh", MODEL_LAYOUT_CASES,
                         ids=[_case_id(c) for c in MODEL_LAYOUT_CASES])
def test_model_layout_matches_blockwise_attention(S, chunk, window, causal,
                                                  H, KV, dh):
    B = 2
    arrays = _inputs(S if dh == 80 else S + dh, B, H, KV, S, dh,
                     layout="model")
    (jq, jk, jv), (q, k, v) = _both(arrays, "bf16")
    want = rattn.blockwise_attention(jq, jk, jv, causal=causal, window=window,
                                     chunk=chunk)
    got = fa.flash_attention_kernel(q, k, v, causal=causal, window=window,
                                    chunk=chunk)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, dh)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-2)


def test_pick_chunk_matches_reference():
    for s in (1, 64, 100, 200, 211, 1024, 2048, 2049, 4096, 5000):
        for chunk in (64, 128, 1024):
            assert fa.pick_chunk(s, chunk) == rattn._pick_chunk(s, chunk)


def test_cpu_dispatch_never_builds(monkeypatch):
    from repro_torch.kernels import build

    def no_build(name):
        raise AssertionError("the CPU path must not build a CUDA kernel")

    monkeypatch.setattr(build, "load", no_build)
    before = fa.flash_attention_cuda.launches
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 2, 1, 32, 16,
                                                   layout="model"))
    out = fa.flash_attention_kernel(q, k, v, causal=True)
    assert out.shape == q.shape
    assert fa.flash_attention_cuda.launches == before


# (S, chunk, window, prefix, H, KV, dh): the vlm family's image prefix,
# causal, inside the first chunk (the reference asserts it fits one), with
# and without a window that would otherwise hide the prefix's keys.
PREFIX_CASES = [
    (200, 64, None, 8, 4, 2, 16),       # internvl2-2b's reduced shape
    (256, 128, None, 100, 4, 2, 64),
    (211, 64, None, 64, 4, 4, 80),      # ragged, the prefix a whole chunk
    (256, 64, 50, 40, 8, 2, 128),       # window: prefix keys stay visible
    (130, 1024, 32, 17, 2, 1, 64),      # one chunk, prefix edge mid-tile
]


@pytest.mark.parametrize("S,chunk,window,prefix,H,KV,dh", PREFIX_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-p{c[3]}-dh{c[6]}"
                              for c in PREFIX_CASES])
def test_bidirectional_prefix_matches_blockwise_attention(S, chunk, window,
                                                          prefix, H, KV, dh):
    B = 2
    arrays = _inputs(S + prefix, B, H, KV, S, dh, layout="model")
    (jq, jk, jv), (q, k, v) = _both(arrays, "bf16")
    want = rattn.blockwise_attention(jq, jk, jv, causal=True, window=window,
                                     chunk=chunk, bidirectional_prefix=prefix)
    got = fa.flash_attention_kernel(q, k, v, causal=True, window=window,
                                    chunk=chunk, bidirectional_prefix=prefix)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-2)
    # The prefix changes the rows inside it and nothing after the window.
    plain = fa.flash_attention_plain(q, k, v, causal=True, window=window,
                                     chunk=chunk)
    assert not torch.equal(got[:, :prefix], plain[:, :prefix])
    if window is None:
        assert torch.equal(got[:, prefix:], plain[:, prefix:])


def test_prefix_must_fit_one_chunk():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 2, 256, 16,
                                                   layout="model"))
    with pytest.raises(ValueError, match="fit one chunk"):
        fa.flash_attention_plain(q, k, v, causal=True, chunk=64,
                                 bidirectional_prefix=65)


@pytest.mark.parametrize("dh,want", [(16, 64), (64, 64), (72, 80), (80, 80),
                                     (96, 128), (160, 256), (256, 256)])
def test_kernel_head_dim(dh, want):
    assert fa.kernel_head_dim(dh) == want


def test_head_dim_above_256_raises():
    with pytest.raises(ValueError, match="above the largest"):
        fa.kernel_head_dim(257)


# (dh, causal, window, prefix, Sq, Sk): the head dims the CUDA wrapper pads
# (every reduced config's 16, stablelm-12b's 160), causal and not, the
# cross-attention's Sq != Sk.
PAD_CASES = [(16, True, None, 0, 96, 96), (16, True, 32, 8, 96, 96),
             (160, True, None, 0, 80, 80), (160, False, None, 0, 64, 75),
             (40, False, None, 0, 48, 30)]


@pytest.mark.parametrize("dh,causal,window,prefix,Sq,Sk", PAD_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_padded_head_dim_at_real_scale_equals_unpadded(dh, causal, window,
                                                       prefix, Sq, Sk, dtype):
    """What the CUDA wrapper does for a dh it is not compiled for: q, k, v
    zero-padded to ``kernel_head_dim(dh)``, the real dh's scale, the output
    sliced back.  Zero columns add nothing to a score, so the plain version
    gives the unpadded answer (float32 sums of the same products with zeros
    between; bf16 outputs the same after rounding)."""
    rng = np.random.default_rng(dh + Sq)
    tdt = DTYPES[dtype][1]
    q = torch.from_numpy(rng.standard_normal((2, Sq, 4, dh)).astype(
        np.float32)).to(tdt)
    k, v = (torch.from_numpy(rng.standard_normal((2, Sk, 2, dh)).astype(
        np.float32)).to(tdt) for _ in range(2))
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    bidirectional_prefix=prefix)
    dk = fa.kernel_head_dim(dh)
    padded = [fa.pad_head_dim(t, dk) for t in (q, k, v)]
    assert padded[0].shape[-1] == dk and torch.equal(padded[0][..., :dh], q)
    got = fa.flash_attention_plain(*padded, causal=causal, window=window,
                                   bidirectional_prefix=prefix,
                                   scale=dh ** -0.5)
    assert torch.equal(got[..., dh:], torch.zeros_like(got[..., dh:]))
    np.testing.assert_allclose(_f32(got[..., :dh]), _f32(want),
                               atol=1e-6 if dtype == "f32" else 1e-2,
                               rtol=0)

"""The attention gradient: the ``flash_attention`` backward's plain torch
version (``flash_attention_bwd_plain``, the arithmetic of the backward
CUDA kernel) against ``jax.vjp`` of the JAX package's
``blockwise_attention`` and against torch autograd through
``flash_attention_plain``, over causal, windowed, non-causal
(cross-attention), bidirectional-prefix, GQA and ragged shapes.

Bars, each relative to max |grad| of the reference side:

* float32, 1e-5: the same algorithm, summed in another order.  The
  reference casts its matmul inputs to its ``COMPUTE_DTYPE`` (bfloat16);
  the float32 comparison sets that module name to float32 for the test, so
  both sides compute the function in float32 (nothing in the JAX package
  changes).
* bfloat16 against ``jax.vjp``, 3e-2: the reference rounds each block's
  gradient contribution to bfloat16 and sums the blocks in bfloat16, the
  plain version sums in float32 and rounds once (measured <= 7.2e-3,
  about one bfloat16 ulp of the largest gradient).
* bfloat16 against torch autograd through the plain forward, 3e-2: autograd
  rounds the bfloat16 casts' gradients at other places (measured <=
  7.2e-3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as rattn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

F32_BAR = 1e-5
BF16_BAR = 3e-2

# (B, Sq, Sk, H, KV, dh, causal, window, prefix, chunk)
CASES = {
    "causal-gqa": (2, 128, 128, 4, 2, 16, True, None, 0, 64),
    "window-mqa": (2, 200, 200, 4, 1, 16, True, 50, 0, 64),
    "ragged-window": (2, 211, 211, 4, 2, 16, True, 70, 0, 64),
    "noncausal-cross": (2, 96, 80, 4, 4, 16, False, None, 0, 64),
    "prefix": (2, 160, 160, 4, 2, 16, True, None, 24, 64),
    "prefix-window": (2, 160, 160, 4, 2, 16, True, 40, 24, 64),
    "dh80": (1, 128, 128, 4, 2, 80, True, None, 0, 64),
}


def _inputs(case, seed=0):
    B, Sq, Sk, H, KV, dh = CASES[case][:6]
    rng = np.random.default_rng(seed)
    shapes = [(B, Sq, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dh),
              (B, Sq, H, dh)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _mask_kw(case):
    causal, window, prefix, chunk = CASES[case][6:]
    return dict(causal=causal, window=window, chunk=chunk,
                bidirectional_prefix=prefix)


def _plain_grads(q, k, v, do, kw):
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    return fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)


def _rel(got, want):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(g, np.float32) - w).max()
                 / np.abs(w).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_vjp(case, dtype, monkeypatch):
    kw = _mask_kw(case)
    arrays = _inputs(case)
    jdt, tdt, bar = {"f32": (jnp.float32, torch.float32, F32_BAR),
                     "bf16": (jnp.bfloat16, torch.bfloat16, BF16_BAR)}[dtype]
    if dtype == "f32":
        monkeypatch.setattr(rattn, "COMPUTE_DTYPE", jnp.float32)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: rattn.blockwise_attention(
        q, k, v, causal=kw["causal"], window=kw["window"], chunk=kw["chunk"],
        bidirectional_prefix=kw["bidirectional_prefix"]), jq, jk, jv)
    want = vjp(jdo)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = _plain_grads(q, k, v, do, kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        assert _rel(g, w) <= bar, (name, _rel(g, w))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_autograd(case, dtype):
    kw = _mask_kw(case)
    tdt, bar = {"f32": (torch.float32, F32_BAR),
                "bf16": (torch.bfloat16, BF16_BAR)}[dtype]
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in _inputs(case, 1))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_plain(*leaves, **kw).backward(do)
    with torch.no_grad():
        got = _plain_grads(q, k, v, do, kw)
    for name, g, t in zip("qkv", got, leaves):
        assert _rel(g, t.grad.float().numpy()) <= bar, name


@pytest.mark.parametrize("case", ["causal-gqa", "ragged-window", "prefix",
                                  "noncausal-cross"])
def test_plain_lse_is_the_row_logsumexp(case):
    """The plain forward's lse is log sum exp of the visible scaled scores,
    the quantity the CUDA forward writes for the backward."""
    kw = _mask_kw(case)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(case, 2))
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    kx = k.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kx) * dh ** -0.5
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    vis = torch.ones((Sq, Sk), dtype=torch.bool)
    if kw["causal"]:
        vis &= qp >= kp
    if kw["window"]:
        vis &= qp - kp < kw["window"]
    if kw["bidirectional_prefix"]:
        vis |= kp < kw["bidirectional_prefix"]
    want = torch.logsumexp(torch.where(vis, s, -torch.inf), dim=-1)
    assert lse.shape == (B, H, Sq)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5)


def test_cpu_dispatch_differentiates_the_plain_version():
    """On the CPU the dispatcher is the plain version, and autograd through
    it gives the plain backward's gradients."""
    kw = _mask_kw("window-mqa")
    q, k, v, do = (torch.from_numpy(a) for a in _inputs("window-mqa", 3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    chunk = kw.pop("chunk")
    fa.flash_attention_kernel(*leaves, chunk=chunk, **kw).backward(do)
    got = _plain_grads(q, k, v, do, dict(kw, chunk=chunk))
    for g, t in zip(got, leaves):
        assert _rel(g, t.grad.numpy()) <= F32_BAR


def test_backward_wrapper_takes_cuda_tensors_only():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs("causal-gqa"))
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1])
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, k, v, q, lse, do, causal=True)

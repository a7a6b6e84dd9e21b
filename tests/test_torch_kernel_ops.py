"""The model kernels as custom operators: their fake implementations give
the shapes and dtypes of the plain versions' outputs, their FLOP formulas
are the kernel modules' count functions, ``torch.library.opcheck`` passes
on the shapes alone, and ``resolve_device`` admits a card it does not have
only inside a ``FakeTensorMode``.

The CUDA implementations run on the card only (``chip_smoke.py`` phase
"dryrun" runs ``opcheck`` there on real inputs).  Here the fake inputs are
fake CUDA tensors where torch is built with CUDA, else ``meta`` tensors
(a build without CUDA cannot slice a fake CUDA tensor)."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss

torch.set_num_threads(2)

FAKE_DEVICE = "cuda" if torch.backends.cuda.is_built() else "meta"

# (B, S, H, KV, dh, Sk, causal, window, prefix)
ATTN = {"dh64": (2, 40, 4, 2, 64, 40, True, None, 0),
        "dh80-window": (1, 48, 4, 1, 80, 48, True, 16, 0),
        "dh160-padded": (1, 24, 2, 2, 160, 24, True, None, 0),
        "dh80-cross": (2, 16, 4, 4, 80, 28, False, None, 0),
        "dh64-prefix": (1, 40, 2, 2, 64, 40, True, None, 8)}
# (B, S, H, P, N): the compiled (64, 128) and a padded (16, 64)
SSD = {"p64n128": (1, 80, 2, 64, 128), "p16n64-padded": (2, 64, 3, 16, 64)}


def _attn_inputs(case, device, fake_mode=None):
    B, S, H, KV, dh, Sk, *_ = ATTN[case]
    gen = np.random.default_rng(0)

    def make(*shape):
        if fake_mode is not None:
            return torch.empty(shape, dtype=torch.bfloat16, device=device)
        return torch.from_numpy(gen.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q, k, v = make(B, S, H, dh), make(B, Sk, KV, dh), make(B, Sk, KV, dh)
    return q, k, v


def _meta(t):
    return (tuple(t.shape), t.dtype)


@pytest.mark.parametrize("case", list(ATTN))
def test_attention_fake_impls_match_the_plain_shapes(case):
    B, S, H, KV, dh, Sk, causal, window, prefix = ATTN[case]
    q, k, v = _attn_inputs(case, "cpu")
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_plain(q, k, v, bidirectional_prefix=prefix,
                                      return_lse=True, **kw)
    grads = fa.flash_attention_bwd_plain(q, k, v, o, lse, o,
                                         bidirectional_prefix=prefix, **kw)
    with FakeTensorMode() as mode:
        fq, fk, fv = _attn_inputs(case, FAKE_DEVICE, mode)
        fo = fa.flash_attention_cuda(fq, fk, fv, prefix=prefix, **kw)
        fo2, flse = fa.flash_attention_cuda(fq, fk, fv, prefix=prefix,
                                            return_lse=True, **kw)
        fgrads = fa.flash_attention_bwd_cuda(fq, fk, fv, fo2, flse, fo2,
                                             prefix=prefix, **kw)
    assert _meta(fo) == _meta(fo2) == _meta(o)
    assert _meta(flse) == _meta(lse)
    assert [_meta(t) for t in fgrads] == [_meta(t) for t in grads]
    dk = fa.kernel_head_dim(dh)
    # A padded dh comes back as a view of the padded buffer, as on the card.
    assert fo.stride() == (S * H * dk, H * dk, dk, 1)
    assert fgrads[1].stride() == (Sk * KV * dk, KV * dk, dk, 1)
    assert fo.device.type == FAKE_DEVICE


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("case", list(SSD))
def test_ssd_fake_impls_match_the_plain_shapes(case, with_init):
    B, S, H, P, N = SSD[case]
    gen = np.random.default_rng(1)

    def inputs(device, fake):
        def make(shape, dtype, scale=1.0):
            if fake:
                return torch.empty(shape, dtype=dtype, device=device)
            return (torch.from_numpy(gen.standard_normal(shape).astype(
                np.float32)) * scale).to(dtype)
        x = make((B, S, H, P), torch.bfloat16)
        dt = make((B, S, H), torch.float32, 0.1).abs()
        a = -make((H,), torch.float32).abs()
        b, c = (make((B, S, N), torch.bfloat16) for _ in range(2))
        init = make((B, H, P, N), torch.float32) if with_init else None
        return x, dt, a, b, c, init

    x, dt, a, b, c, init = inputs("cpu", False)
    y, final = ss.ssd_scan_plain(x, dt, a, b, c, ss.KERNEL_CHUNK, init)
    states = ss.ssd_chunk_states_plain(x, dt, a, b, c, init)
    dx, ddt, da, db, dc, dinit = ss.ssd_scan_bwd_plain(
        x, dt, a, b, c, ss.KERNEL_CHUNK, init, y, final)
    with FakeTensorMode():
        fx, fdt, fa_, fb, fc, finit = inputs(FAKE_DEVICE, True)
        fy, ffinal = ss.ssd_scan_cuda(fx, fdt, fa_, fb, fc, finit)
        _, _, fstates = ss.ssd_scan_cuda(fx, fdt, fa_, fb, fc, finit,
                                         states=True)
        fgrads = ss.ssd_scan_bwd_cuda(fx, fdt, fa_, fb, fc, fstates, fy,
                                      ffinal)
    assert (_meta(fy), _meta(ffinal)) == (_meta(y), _meta(final))
    # The chunk states come in the padded shape the backward takes.
    assert _meta(fstates) == ((B, ss.n_chunks(S), H, ss.KERNEL_P,
                               ss.KERNEL_N), torch.float32)
    assert tuple(states.shape) == (B, ss.n_chunks(S), H, P, N)
    assert [_meta(t) for t in fgrads[:5]] == [_meta(t) for t in
                                              (dx, ddt, da, db, dc)]
    assert _meta(fgrads[5]) == ((B, H, P, N), torch.float32)
    if with_init:
        assert _meta(dinit) == _meta(fgrads[5])
    assert fy.stride() == (S * H * ss.KERNEL_P, H * ss.KERNEL_P, ss.KERNEL_P,
                           1)


@pytest.mark.parametrize("case", list(ATTN))
def test_attention_flop_formulas_are_the_count_functions(case):
    B, S, H, KV, dh, Sk, causal, window, prefix = ATTN[case]
    dk = fa.kernel_head_dim(dh)
    with FakeTensorMode() as mode:
        q, k, v = _attn_inputs(case, FAKE_DEVICE, mode)
        with FlopCounterMode(display=False) as fwd:
            o, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                             window=window, prefix=prefix,
                                             return_lse=True)
        with FlopCounterMode(display=False) as bwd:
            fa.flash_attention_bwd_cuda(q, k, v, o, lse, o, causal=causal,
                                        window=window, prefix=prefix)
    live = fa.live_entries(S, Sk, causal, window, prefix)
    assert fwd.get_total_flops() == fa.attention_flops(
        B, H, S, Sk, dk, causal, window, prefix) == 4 * B * H * dk * live
    assert bwd.get_total_flops() == fa.attention_bwd_flops(
        B, H, S, Sk, dk, causal, window, prefix) == 14 * B * H * dk * live
    assert fa.attention_bwd_flops(B, H, S, Sk, dh, causal, window, prefix,
                                  fa.BWD_PRODUCTS) == 10 * B * H * dh * live


@pytest.mark.parametrize("case", list(SSD))
def test_ssd_flop_formulas_are_the_count_functions(case):
    B, S, H, P, N = SSD[case]
    with FakeTensorMode():
        def make(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=FAKE_DEVICE)
        x, dy = make((B, S, H, P), torch.bfloat16), make((B, S, H, P),
                                                         torch.bfloat16)
        dt, a = make((B, S, H), torch.float32), make((H,), torch.float32)
        b, c = make((B, S, N), torch.bfloat16), make((B, S, N),
                                                     torch.bfloat16)
        with FlopCounterMode(display=False) as fwd:
            _, _, states = ss.ssd_scan_cuda(x, dt, a, b, c, states=True)
        with FlopCounterMode(display=False) as bwd:
            ss.ssd_scan_bwd_cuda(x, dt, a, b, c, states, dy)
    assert fwd.get_total_flops() == ss.ssd_flops(B, S, H, ss.KERNEL_P,
                                                 ss.KERNEL_N)
    assert bwd.get_total_flops() == ss.ssd_bwd_flops(B, S, H, ss.KERNEL_P,
                                                     ss.KERNEL_N)


@pytest.mark.parametrize("S,sk,causal,window,prefix", [
    (37, 37, True, None, 0), (37, 37, True, 5, 0), (37, 37, True, None, 9),
    (37, 37, True, 5, 9), (20, 33, False, None, 0), (33, 20, True, None, 0),
    (16, 16, False, 4, 3)])
def test_live_entries_count_the_unmasked_scores(S, sk, causal, window,
                                                prefix):
    q = np.arange(S)[:, None]
    k = np.arange(sk)[None, :]
    live = np.ones((S, sk), bool)
    if causal:
        live &= k <= q
    if window:
        live &= q - k < window
    live |= k < prefix
    assert fa.live_entries(S, sk, causal, window, prefix) == int(live.sum())


def _meta_inputs():
    def make(shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    q, k = make((1, 32, 4, 80)), make((1, 32, 2, 80))
    o, lse = make((1, 32, 4, 80)), make((1, 4, 32), torch.float32)
    x, dt = make((1, 64, 2, 64)), make((1, 64, 2), torch.float32)
    a, b = make((2,), torch.float32), make((1, 64, 128))
    states = make((1, 1, 2, 64, 128), torch.float32)
    return {
        "flash_attention": (q, k, k, True, None, 0, True),
        "flash_attention_bwd": (q, k, k, o, lse, o, True, None, 0),
        "ssd_scan": (x, dt, a, b, b, None, True),
        "ssd_scan_bwd": (x, dt, a, b, b, states, x, None, False)}


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd",
                                  "ssd_scan", "ssd_scan_bwd"])
def test_opcheck_on_shapes(name):
    """``opcheck``'s schema, autograd-registration and fake-tensor checks on
    meta inputs (the fake implementation against itself run as the meta
    kernel: the schema and the registrations are what this holds; the card
    checks the CUDA implementation)."""
    torch.library.opcheck(getattr(torch.ops.repro_torch, name),
                          _meta_inputs()[name],
                          test_utils=("test_schema",
                                      "test_autograd_registration",
                                      "test_faketensor"))


def test_resolve_device_admits_a_missing_card_only_in_a_trace(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.resolve_device(None)
    assert not ops.faking()
    with FakeTensorMode():
        assert ops.faking()
        assert ops.resolve_device("cuda") == torch.device("cuda")
        assert ops.resolve_device(None) == torch.device("cuda")
    assert not ops.faking()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.resolve_device("cuda")


def test_wrappers_still_refuse_host_tensors_in_a_trace():
    """Inside a trace a CPU tensor is still no operand of the ops: the
    wrappers raise instead of running the plain versions."""
    with FakeTensorMode():
        q = torch.empty((1, 8, 2, 64), dtype=torch.bfloat16)
        before = fa.flash_attention_cuda.launches
        with pytest.raises(ValueError, match="CUDA tensors"):
            fa.flash_attention_cuda(q, q, q, causal=True)
    assert fa.flash_attention_cuda.launches == before

"""The ``ssd_scan`` kernel's plain torch version against the JAX package:
its Pallas kernel (interpret mode, through ``repro.kernels.ops``), its
sequential oracle ``ref.ssd_ref`` and the model's ``ssd_chunked`` (output
and final state, with and without an initial state).

Bars: ``tests/test_kernels.py``'s, errors normalised by the reference's
max |value|: atol 2e-3 in float32 and 4e-2 in bfloat16 (measured: <= 4e-6
and <= 7.7e-3 against the Pallas kernel; 0 to 4e-4 against
``ssd_chunked``, which rounds at the same places)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 4e-2)}
SHAPES = [(1, 128, 2, 64, 128, 64),
          (2, 256, 4, 64, 128, 128),
          (1, 256, 2, 128, 64, 128)]


def _inputs(seed, B, S, H, P, N):
    """x, dt (softplus'd), a (negative), b, c, init_state as float32 numpy,
    at the scales of tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    b = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    init = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, a, b, c, init


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    got, want = _f32(got), _f32(want)
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_and_oracle(B, S, H, P, N, chunk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, dt, a, b, c, _ = _inputs(S + P, B, S, H, P, N)
    jx, jdt_, jb, jc = (jnp.asarray(t, jdt) for t in (x, dt, b, c))
    tx, tdt_, tb, tc = (torch.from_numpy(t).to(tdt) for t in (x, dt, b, c))
    ta = torch.from_numpy(a)
    got = ops.ssd_scan(tx, tdt_, ta, tb, tc, chunk=chunk, device="cpu")
    assert got.dtype == tdt and got.shape == (B, S, H, P)
    _close(got, rops.ssd_scan(jx, jdt_, jnp.asarray(a), jb, jc, chunk=chunk),
           tol)
    _close(got, rref.ssd_ref(jx, jdt_, jnp.asarray(a), jb, jc), tol)
    _close(got, ref.ssd_ref(tx, tdt_, ta, tb, tc), tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_init", [False, True])
def test_plain_matches_ssd_chunked(B, S, H, P, N, chunk, dtype, with_init):
    """The model's contract: y and the float32 final state."""
    jdt, tdt, tol = DTYPES[dtype]
    x, dt, a, b, c, init = _inputs(S + 3, B, S, H, P, N)
    jy, jf = rssm.ssd_chunked(
        jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(a),
        jnp.asarray(b, jdt), jnp.asarray(c, jdt), chunk,
        init_state=jnp.asarray(init) if with_init else None)
    y, f = ssm.ssd_chunked(
        torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(a),
        torch.from_numpy(b).to(tdt), torch.from_numpy(c).to(tdt), chunk,
        init_state=torch.from_numpy(init) if with_init else None)
    assert y.dtype == tdt and f.dtype == torch.float32
    assert f.shape == (B, H, P, N)
    _close(y, jy, tol)
    _close(f, jf, tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernel_chunk_gives_the_models_function(dtype):
    """The CUDA kernel scans in chunks of KERNEL_CHUNK whatever the model's
    ssm_chunk (256 for mamba2-370m): the chunked dual form is exact for any
    chunk, so the plain version at KERNEL_CHUNK matches ssd_chunked at 256
    and the token-by-token recurrence."""
    _, tdt, tol = DTYPES[dtype]
    B, S, H, P, N = 1, 512, 2, 64, 128
    x, dt, a, b, c, init = (torch.from_numpy(t) for t in
                            _inputs(11, B, S, H, P, N))
    x, b, c = x.to(tdt), b.to(tdt), c.to(tdt)
    y64, f64 = ss.ssd_scan_plain(x, dt, a, b, c, ss.KERNEL_CHUNK, init)
    y256, f256 = ss.ssd_scan_plain(x, dt, a, b, c, 256, init)
    _close(y64, y256.float().numpy(), tol)
    _close(f64, f256.numpy(), tol)
    y_seq, f_seq = ssm.ssd_reference(x, dt, a, b, c)
    y0, f0 = ss.ssd_scan_plain(x, dt, a, b, c, ss.KERNEL_CHUNK)
    _close(y0, y_seq.numpy(), tol)
    _close(f0, f_seq.numpy(), tol)


def test_reference_recurrence_matches_jax():
    B, S, H, P, N = 2, 64, 3, 16, 8
    x, dt, a, b, c, _ = _inputs(5, B, S, H, P, N)
    jy, jf = rssm.ssd_reference(*(jnp.asarray(t) for t in (x, dt, a, b, c)))
    y, f = ssm.ssd_reference(*(torch.from_numpy(t) for t in (x, dt, a, b, c)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5)


def test_segsum_matches_reference():
    dA = np.random.default_rng(2).standard_normal((2, 3, 16)).astype(np.float32)
    got = ss.segsum(torch.from_numpy(dA)).numpy()
    want = np.asarray(rssm.segsum(jnp.asarray(dA)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5)


def test_cpu_dispatch_never_builds(monkeypatch):
    from repro_torch.kernels import build

    def no_build(name):
        raise AssertionError("the CPU path must not build a CUDA kernel")

    monkeypatch.setattr(build, "load", no_build)
    before = ss.ssd_scan_cuda.launches
    x, dt, a, b, c, _ = (torch.from_numpy(t) for t in
                         _inputs(1, 1, 32, 2, 16, 8))
    y, f = ss.ssd_scan_kernel(x, dt, a, b, c, 16)
    assert y.shape == x.shape and f.shape == (1, 2, 16, 8)
    assert ss.ssd_scan_cuda.launches == before


# (P, N, with_init): the shapes the CUDA wrapper pads to (64, 128): every
# reduced ssm config's (16, 16), the 100m preset's (16, 64), and one side
# padded at a time.
PAD_SHAPES = [(16, 16, False), (16, 64, True), (64, 16, True),
              (32, 128, False)]


@pytest.mark.parametrize("P,N,with_init", PAD_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_padded_shape_equals_unpadded(P, N, with_init, dtype):
    """What the CUDA wrapper does for a (P, N) it is not compiled for: x
    zero-padded to P = 64, b and c to N = 128, the initial state to both,
    y and the final state sliced back.  Zero columns of x give zero rows of
    the state and of y, zero columns of b and c add nothing, so the plain
    version gives the unpadded answer and zeros in the padding."""
    _, tdt, _ = DTYPES[dtype]
    B, S, H = 2, 128, 3
    x, dt, a, b, c, init = (torch.from_numpy(t) for t in
                            _inputs(P + N, B, S, H, P, N))
    x, b, c = x.to(tdt), b.to(tdt), c.to(tdt)
    init = init if with_init else None
    y, fin = ss.ssd_scan_plain(x, dt, a, b, c, ss.KERNEL_CHUNK, init)
    xp, bp, cp, ip = ss.pad_shape(x, b, c, init)
    assert xp.shape[-1] == ss.KERNEL_P and bp.shape[-1] == ss.KERNEL_N
    assert torch.equal(xp[..., :P], x) and torch.equal(cp[..., :N], c)
    y_p, fin_p = ss.ssd_scan_plain(xp, dt, a, bp, cp, ss.KERNEL_CHUNK, ip)
    assert not y_p[..., P:].any() and not fin_p[:, :, P:].any()
    assert not fin_p[..., N:].any()
    np.testing.assert_allclose(_f32(y_p[..., :P]), _f32(y),
                               atol=1e-5 if dtype == "f32" else 1e-2, rtol=0)
    np.testing.assert_allclose(_f32(fin_p[:, :, :P, :N]), _f32(fin),
                               atol=1e-5, rtol=0)


def test_shape_above_the_kernels_is_refused():
    x, dt, a, b, c, _ = (torch.from_numpy(t) for t in
                         _inputs(3, 1, 16, 2, 128, 16))
    with pytest.raises(ValueError, match="above the compiled"):
        ss.pad_shape(x, b, c)

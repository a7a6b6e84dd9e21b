"""The SSD scan's gradient: ``ssd_scan_bwd_plain`` (the arithmetic of the
backward CUDA kernel ``csrc/ssd_scan_bwd.cu``) against ``jax.vjp`` of the
JAX package's ``ssd_chunked`` and against torch autograd through
``ssd_scan_plain``, with and without an initial state and a final-state
cotangent, at chunk 64 and 256, a ragged S (300 tokens, which the chunk
shrinks to 60 to divide) and padded (P, N); a ragged S padded with dt = 0
tokens to the kernel's chunks; the ``SSDScan`` autograd Function's glue
with the CUDA wrappers swapped for plain versions; the plain renderings of
the faults ``chip_smoke.py`` holds the kernel's bar against; and its byte
bound.

Inputs are made with numpy from fixed seeds, dt and A from Mamba2's own
ranges (softplus(dt_bias) log-uniform in [1e-3, 0.1], -A uniform in [1,
16]), as the model and ``chip_smoke.py`` draw them.  Bars, each relative to
max |grad| of the reference side:

* float32, 1e-5: the same function, summed in another order (measured <=
  4.7e-6, da at chunk 256).  With dt up to 0.3 and -A up to 8 instead the
  reference's own float32 da drifts 1.3e-5 of max |da| off a float64
  evaluation (the plain version's 2.9e-6), so these ranges are the ones the
  model gives, not a choice that hides a gap.
* bfloat16, 2e-2: the plain version rounds dx, db and dc to bfloat16 once
  at the end, the reference rounds every cotangent of a bfloat16 tensor on
  its way (measured <= 5.8e-3 against both references, about one bfloat16
  ulp of the largest gradient, and four times that is the bar).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as rssm  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

F32_BAR = 1e-5
BF16_BAR = 2e-2
NAMES = ("dx", "ddt", "da", "db", "dc", "dinit")

# (B, S, H, P, N, chunk, initial state, final-state cotangent)
CASES = {
    "zero-state": (2, 128, 3, 16, 32, 64, False, False),
    "init-and-dfinal": (2, 128, 3, 16, 32, 64, True, True),
    "init-only": (2, 192, 3, 16, 32, 64, True, False),
    "dfinal-only": (2, 256, 4, 8, 16, 64, False, True),
    "chunk256": (2, 256, 2, 16, 32, 256, True, False),
    "ragged": (2, 300, 3, 16, 32, 64, True, True),
}


def _inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "x": rng.standard_normal((B, S, H, P)).astype(f32),
        "dt": np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                 (B, S, H))).astype(f32),
        "a": -rng.uniform(1.0, 16.0, (H,)).astype(f32),
        "b": rng.standard_normal((B, S, N)).astype(f32),
        "c": rng.standard_normal((B, S, N)).astype(f32),
        "init": rng.standard_normal((B, H, P, N)).astype(f32),
        "dy": rng.standard_normal((B, S, H, P)).astype(f32),
        "dfinal": rng.standard_normal((B, H, P, N)).astype(f32),
    }


def _torch_args(arr, dtype, init, dfinal):
    """(x, dt, a, b, c, init_state, dy, dfinal) as the port takes them: x,
    b, c and dy in ``dtype``, the rest float32, None where absent."""
    low = {k: torch.tensor(arr[k]).to(dtype) for k in ("x", "b", "c", "dy")}
    return (low["x"], torch.tensor(arr["dt"]), torch.tensor(arr["a"]),
            low["b"], low["c"], torch.tensor(arr["init"]) if init else None,
            low["dy"], torch.tensor(arr["dfinal"]) if dfinal else None)


def _rel(got, want):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(g, np.float32) - w).max()
                 / np.abs(w).max())


def _check(got, want, bar):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == tuple(w.shape), name
        assert _rel(g, w) <= bar, (name, _rel(g, w))


def _plain(arr, case, dtype):
    B, S, H, P, N, chunk, init, dfinal = CASES[case]
    x, dt, a, b, c, s0, dy, df = _torch_args(arr, dtype, init, dfinal)
    return ss.ssd_scan_bwd_plain(x, dt, a, b, c, chunk, s0, dy, df)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_vjp(case, dtype):
    B, S, H, P, N, chunk, init, dfinal = CASES[case]
    arr = _inputs(B, S, H, P, N)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    args = [jnp.asarray(arr["x"]).astype(jd), jnp.asarray(arr["dt"]),
            jnp.asarray(arr["a"]), jnp.asarray(arr["b"]).astype(jd),
            jnp.asarray(arr["c"]).astype(jd)]
    if init:
        args.append(jnp.asarray(arr["init"]))

    def fn(*t):
        return rssm.ssd_chunked(*t[:5], chunk, t[5] if init else None)

    (_, fin), vjp = jax.vjp(fn, *args)
    cot_fin = jnp.asarray(arr["dfinal"]) if dfinal else jnp.zeros_like(fin)
    want = vjp((jnp.asarray(arr["dy"]).astype(jd), cot_fin))
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    want += [None] * (6 - len(want))
    _check(_plain(arr, case, td), want,
           BF16_BAR if dtype == "bf16" else F32_BAR)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_autograd(case, dtype):
    B, S, H, P, N, chunk, init, dfinal = CASES[case]
    arr = _inputs(B, S, H, P, N, seed=1)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    x, dt, a, b, c, s0, dy, df = _torch_args(arr, td, init, dfinal)
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, b, c)]
    if init:
        leaves.append(s0.clone().requires_grad_())
    y, fin = ss.ssd_scan_plain(*leaves[:5], chunk,
                               leaves[5] if init else None)
    want = torch.autograd.grad(
        (y, fin), leaves, (dy, df if dfinal else torch.zeros_like(fin)))
    want = [w.float().numpy() for w in want] + [None] * (6 - len(want))
    _check(ss.ssd_scan_bwd_plain(x, dt, a, b, c, chunk, s0, dy, df), want,
           BF16_BAR if dtype == "bf16" else F32_BAR)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernel_chunk_gives_the_models_gradient(dtype):
    """The kernel scans in chunks of 64, the model names 256: the gradient
    is the same function."""
    arr = _inputs(2, 256, 3, 16, 32, seed=2)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    args = _torch_args(arr, td, True, True)
    at64 = ss.ssd_scan_bwd_plain(*args[:5], ss.KERNEL_CHUNK, *args[5:])
    at256 = ss.ssd_scan_bwd_plain(*args[:5], 256, *args[5:])
    _check(at64, [w.float().numpy() for w in at256],
           BF16_BAR if dtype == "bf16" else F32_BAR)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_init", [False, True])
def test_padded_shape_equals_unpadded(with_init, dtype):
    """Zero columns of P and N, as the kernel's wrapper pads them, give the
    same gradient of the real columns and zero gradients of the padded
    ones."""
    P, N = 16, 16
    arr = _inputs(1, 128, 2, P, N, seed=3)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    x, dt, a, b, c, s0, dy, df = _torch_args(arr, td, with_init, True)
    want = ss.ssd_scan_bwd_plain(x, dt, a, b, c, 64, s0, dy, df)
    xp, bp, cp, s0p = ss.pad_shape(x, b, c, s0)
    _, _, _, dfp = ss.pad_shape(x, b, c, df)
    dyp = torch.nn.functional.pad(dy, (0, ss.KERNEL_P - P))
    got = ss.ssd_scan_bwd_plain(xp, dt, a, bp, cp, 64, s0p, dyp, dfp)
    tol = 1e-6 if dtype == "f32" else 1e-2
    real = (got[0][..., :P], got[1], got[2], got[3][..., :N],
            got[4][..., :N],
            None if got[5] is None else got[5][:, :, :P, :N])
    for name, g, w in zip(NAMES, real, want):
        if w is None:
            assert g is None
            continue
        assert _rel(g, w.float().numpy()) <= tol, name
    pads = [got[0][..., P:], got[3][..., N:], got[4][..., N:]]
    if with_init:
        pads += [got[5][:, :, P:], got[5][:, :, :, N:]]
    for t in pads:
        assert not t.float().abs().max().item()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ragged_s_padded_to_the_kernels_chunks(dtype):
    """A ragged S padded with tokens of dt = 0 (``pad_tokens``), as phase
    "ssd backward" hands it to the plain version so that both it and the
    kernel chunk at KERNEL_CHUNK, keeps the gradient of the real tokens:
    300 tokens padded to 320 and scanned in chunks of 64, against the
    unpadded scan, whose chunk shrinks to 60."""
    S = 300
    arr = _inputs(2, S, 3, 16, 32, seed=7)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    x, dt, a, b, c, s0, dy, df = _torch_args(arr, td, True, True)
    want = ss.ssd_scan_bwd_plain(x, dt, a, b, c, ss.KERNEL_CHUNK, s0, dy, df)
    padded = [ss.pad_tokens(t) for t in (x, dt, b, c, dy)]
    assert padded[0].shape[1] == ss.n_chunks(S) * ss.KERNEL_CHUNK == 320
    assert not padded[1][:, S:].any() and torch.equal(padded[1][:, :S], dt)
    xp, dtp, bp, cp, dyp = padded
    got = ss.ssd_scan_bwd_plain(xp, dtp, a, bp, cp, ss.KERNEL_CHUNK, s0,
                                dyp, df)
    assert not got[0][:, S:].any()
    real = (got[0][:, :S], got[1][:, :S], got[2], got[3][:, :S],
            got[4][:, :S], got[5])
    _check(real, [w.float().numpy() for w in want],
           BF16_BAR if dtype == "bf16" else F32_BAR)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("with_state", [False, True])
def test_fault_renderings_exceed_the_bar(with_state):
    """The plain renderings of the four faults phase "ssd backward" shows
    (the state cotangent not carried across chunks, dB and dC from head 0
    only, the off-chunk term dropped from d cum, ddt without d(dA) a) each
    read above the bar the kernel is held to, in bfloat16, at a reduced
    shape with Mamba2's dt and A ranges."""
    cs = _chip_smoke()
    arr = _inputs(2, 256, 8, 16, 32, seed=4)
    args = _torch_args(arr, torch.bfloat16, with_state, with_state)
    x, dt, a, b, c, s0, dy, df = args
    want = ss.ssd_scan_bwd_plain(x, dt, a, b, c, ss.KERNEL_CHUNK, s0, dy, df)
    faults = cs.ssd_bwd_faults(ss, x, dt, a, b, c, s0, dy, df, want)
    assert len(faults) == 4
    assert min(faults.values()) > cs.SSD_BWD_BAR, faults


def _plain_wrappers(calls):
    """Stand-ins for the two CUDA wrappers with their contracts, built from
    the plain versions: inputs zero-padded to (KERNEL_P, KERNEL_N) as
    ``pad_shape`` does, chunk states in the padded shape, the gradients
    sliced back, da the sum of per-(batch, chunk) partials."""
    KP, KN = ss.KERNEL_P, ss.KERNEL_N

    def fwd(x, dt, a, b, c, init_state=None, *, states=False):
        calls.append(("fwd", states))
        P, N = x.shape[-1], b.shape[-1]
        xp, bp, cp, sp = ss.pad_shape(x, b, c, init_state)
        y, fin = ss.ssd_scan_plain(xp, dt, a, bp, cp, ss.KERNEL_CHUNK, sp)
        out = (y[..., :P], fin[:, :, :P, :N])
        return out + (ss.ssd_chunk_states_plain(xp, dt, a, bp, cp, sp),) \
            if states else out

    def bwd(x, dt, a, b, c, states, dy, dfinal=None):
        B, S, H, P = x.shape
        N = b.shape[-1]
        calls.append(("bwd", dfinal is None))
        assert states.shape == (B, ss.n_chunks(S), H, KP, KN)
        assert dy.dtype == x.dtype and dy.shape == x.shape
        xp, bp, cp, dfp = ss.pad_shape(x, b, c, dfinal)
        dyp = torch.nn.functional.pad(dy, (0, KP - P))
        q = ss.KERNEL_CHUNK
        init = states[:, 0]   # the state entering the first chunk
        dx, ddt, _, db, dc, dinit = ss.ssd_scan_bwd_plain(
            xp, dt, a, bp, cp, q, init, dyp, dfp)
        # da as the kernel leaves it: a partial sum per (batch, chunk, head)
        # of d(dA) dt, added up by the wrapper.
        ddA = ss.ssd_scan_bwd_terms(xp, dt, a, bp, cp, q, init, dyp,
                                    dfp)["ddA"]
        nc = ss.n_chunks(S)
        da = torch.nn.functional.pad(ddA * dt, (0, 0, 0, nc * q - S))
        da = da.reshape(B, nc, q, H).sum(dim=2).sum(dim=(0, 1))
        return (dx[..., :P], ddt, da, db[..., :N], dc[..., :N],
                dinit[:, :, :P, :N])

    return fwd, bwd


@pytest.mark.parametrize("with_init", [False, True])
def test_ssdscan_function_glue(with_init, monkeypatch):
    """``SSDScan`` with the CUDA wrappers swapped for plain stand-ins, on
    the CPU: the forward asks for the chunk states, the backward hands the
    saved inputs, the states and the cotangents over in the right order
    (None for an unused final state), and the gradients (bf16 for x, b, c;
    float32 for dt, a and the initial state; None for an absent one) equal
    autograd's through ``ssd_scan_plain``."""
    calls = []
    fwd, bwd = _plain_wrappers(calls)
    monkeypatch.setattr(ss, "ssd_scan_cuda", fwd)
    monkeypatch.setattr(ss, "ssd_scan_bwd_cuda", bwd)
    P, N = 16, 32
    arr = _inputs(2, 128, 3, P, N, seed=5)
    x, dt, a, b, c, s0, dy, _ = _torch_args(arr, torch.bfloat16, with_init,
                                            False)
    # x, b and c as slices of one activation, as the model passes them.
    xbc = torch.cat([x.reshape(2, 128, 3 * P), b, c], dim=-1)

    def leaves():
        t = xbc.clone().requires_grad_()
        rest = [dt.clone().requires_grad_(), a.clone().requires_grad_()]
        init = s0.clone().requires_grad_() if with_init else None
        return t, rest, init

    def split(t):
        return (t[..., :3 * P].reshape(2, 128, 3, P), t[..., 3 * P:3 * P + N],
                t[..., 3 * P + N:])

    t, (dt_, a_), init = leaves()
    xs, bs, cs = split(t)
    y, fin = ss.SSDScan.apply(xs, dt_, a_, bs, cs, init)
    (y.float() * dy.float()).sum().backward()
    assert calls == [("fwd", True), ("bwd", True)]

    t2, (dt2, a2), init2 = leaves()
    xs2, bs2, cs2 = split(t2)
    y2, _ = ss.ssd_scan_plain(xs2, dt2, a2, bs2, cs2, ss.KERNEL_CHUNK, init2)
    (y2.float() * dy.float()).sum().backward()

    assert _rel(y, y2.detach().float().numpy()) <= BF16_BAR
    assert t.grad.dtype == torch.bfloat16
    assert dt_.grad.dtype == a_.grad.dtype == torch.float32
    pairs = [(t.grad, t2.grad), (dt_.grad, dt2.grad), (a_.grad, a2.grad)]
    if with_init:
        assert init.grad.dtype == torch.float32
        pairs.append((init.grad, init2.grad))
    for got, want in pairs:
        assert _rel(got, want.float().numpy()) <= BF16_BAR


def test_bwd_wrapper_refuses_host_tensors():
    arr = _inputs(1, 64, 2, 64, 128)
    x, dt, a, b, c, _, dy, _ = _torch_args(arr, torch.bfloat16, False, False)
    states = torch.zeros((1, 1, 2, ss.KERNEL_P, ss.KERNEL_N))
    before = ss.ssd_scan_bwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.ssd_scan_bwd_cuda(x, dt, a, b, c, states, dy)
    assert ss.ssd_scan_bwd_cuda.launches == before


def test_chunk_states_plain_are_the_scans_states():
    """``ssd_chunk_states_plain`` (the plain version of the forward
    kernel's training output) gives, at each chunk, the final state of the
    scan over the tokens before it, a ragged S included."""
    arr = _inputs(2, 200, 3, 8, 16, seed=6)
    x, dt, a, b, c, s0, _, _ = _torch_args(arr, torch.float32, True, False)
    st = ss.ssd_chunk_states_plain(x, dt, a, b, c, s0)
    assert st.shape == (2, ss.n_chunks(200), 3, 8, 16)
    assert torch.equal(st[:, 0], s0)
    for ci in range(1, st.shape[1]):
        n = ci * ss.KERNEL_CHUNK
        _, fin = ss.ssd_scan_plain(x[:, :n], dt[:, :n], a, b[:, :n],
                                   c[:, :n], ss.KERNEL_CHUNK, s0)
        assert _rel(st[:, ci], fin.numpy()) <= F32_BAR


PTXAS_SSD = """\
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_18d893fe7ssd_fwdILi64ELi128ELb1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_18d893fe7ssd_fwdILi64ELi128ELb1EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 197 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__59688088_15_ssd_scan_bwd_cu_72644c5513ssd_bwd_stateILi1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__59688088_15_ssd_scan_bwd_cu_72644c5513ssd_bwd_stateILi1EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__59688088_15_ssd_scan_bwd_cu_72644c5513ssd_bwd_stateILi2EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__59688088_15_ssd_scan_bwd_cu_72644c5513ssd_bwd_stateILi2EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 176 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__59688088_15_ssd_scan_bwd_cu_72644c5513ssd_bwd_chunkENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__59688088_15_ssd_scan_bwd_cu_72644c5513ssd_bwd_chunkENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 236 registers, used 1 barriers
"""


def test_ptxas_table_reads_the_ssd_kernels():
    """Phase "build" reads the SSD kernels' ptxas lines as it reads the
    attention kernels': the forward with its states flag, the backward's
    two kernels by name (as ``chip_smoke.SSD_BWD_KERNELS`` names them),
    the state cotangent's with its heads a block."""
    cs = _chip_smoke()
    assert {row["kernel"] for row in cs.ptxas_table(PTXAS_SSD)
            if row["kernel"].startswith("ssd_bwd")} == set(cs.SSD_BWD_KERNELS)
    assert cs.ptxas_table(PTXAS_SSD) == [
        {"kernel": "ssd_fwd", "args": "64, 128, states", "registers": 197,
         "stack": 0, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "ssd_bwd_state", "args": "1", "registers": 128,
         "stack": 0, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "ssd_bwd_state", "args": "2", "registers": 176,
         "stack": 0, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "ssd_bwd_chunk", "args": "", "registers": 236,
         "stack": 0, "spill_stores": 0, "spill_loads": 0}]


@pytest.mark.parametrize("init,dfinal", [(False, False), (True, True)])
def test_ssd_bwd_bound_counts_the_operands_only(init, dfinal):
    """The SSD backward's byte bound counts each operand of the gradient
    once (x, dy, dx in bf16; dt, ddt f32; a, da f32; b, c, db, dc bf16; the
    initial state, its cotangent and the final state's cotangent f32 where
    given), and nothing the design keeps besides: the chunk states and the
    state cotangents are ``ssd_bwd_design_bytes``."""
    cs = _chip_smoke()
    B, S, H, P, N, q = 8, 2048, 32, 64, 128, ss.KERNEL_CHUNK
    operands = (3 * 2 * B * S * H * P + 2 * 4 * B * S * H + 2 * 4 * H
                + 4 * 2 * B * S * N
                + 4 * B * H * P * N * (2 * init + dfinal))
    ms, by = cs.ssd_bwd_bound(B, S, H, P, N, q, init, dfinal)
    assert by == "bytes"
    assert ms == pytest.approx(operands / cs.PEAK_BYTES * 1e3, rel=1e-12)
    design = cs.ssd_bwd_design_bytes(B, S, H, q, P, N)
    assert design == 3 * 4 * B * (S // q) * H * P * N


@pytest.mark.parametrize("shape", ["train", "ragged"])
def test_ssd_bwd_kernel_bytes_count_each_launch(shape):
    """Each launch's own traffic, as phase "ssd backward" divides it by the
    launch's device time, counted by hand at mamba2-370m's training shape
    (0.35 GB and 0.76 GB) and at the ragged S (1000 tokens in 16 chunks,
    with a final-state cotangent): ``ssd_bwd_state`` reads dy, c, dt, a
    (and dfinal) and writes G of every chunk and dinit; ``ssd_bwd_chunk``
    reads x, dy, dt, a, b, c, the chunk states and G and writes dx, ddt,
    db, dc and da's partial sums."""
    cs = _chip_smoke()
    B, S, H, dfinal = {"train": (8, 2048, 32, False),
                       "ragged": (2, 1000, 32, True)}[shape]
    P, N, q = ss.KERNEL_P, ss.KERNEL_N, ss.KERNEL_CHUNK
    nc = -(-S // q)
    x = dy = dx = B * S * H * P * 2
    dt = ddt = B * S * H * 4
    b = c = db = dc = B * S * N * 2
    state = B * H * P * N * 4               # dinit, dfinal
    g = states = B * nc * H * P * N * 4      # every chunk's G, chunk states
    want = {"ssd_bwd_state": dy + c + dt + H * 4 + g + state * (1 + dfinal),
            "ssd_bwd_chunk": (x + dy + dt + H * 4 + b + c + states + g + dx
                              + ddt + db + dc + B * nc * H * 4)}
    got = cs.ssd_bwd_kernel_bytes(B, S, H, q, P, N, dfinal)
    assert got == want
    assert set(got) == set(cs.SSD_BWD_KERNELS)
    if shape == "train":
        assert round(got["ssd_bwd_state"] / 1e6) == 350
        assert round(got["ssd_bwd_chunk"] / 1e6) == 759


def test_bulk_copied_operands_must_be_aligned():
    """The backward moves the chunk states by bulk copies and reads dfinal
    in pairs, so the wrapper raises on a view that starts off a 16-byte
    boundary instead of copying it; the model's own operands, x, b and c
    as slices of one conv output (``chip_smoke.ssd_bwd_inputs``), start
    on one."""
    fn = "ssd_scan_bwd_cuda"
    base = torch.zeros(4 * 2 * 64 * 128 + 4)
    ss._check_aligned(fn, "states", base)
    with pytest.raises(ValueError, match="states must start at a 16-byte"):
        ss._check_aligned(fn, "states", base[1:])
    with pytest.raises(ValueError, match="dfinal"):
        ss._check_aligned(fn, "dfinal", base[2:-2].reshape(2, 4, 64, 128))
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    x, dt, a, b, c, init, dy, dfinal = cs.ssd_bwd_inputs(
        torch, gen, torch.device("cpu"), 2, 64, 4, 64, 128, True, True)
    assert x.stride()[:2] == (64 * (4 * 64 + 2 * 128), 4 * 64 + 2 * 128)
    for name, t in (("x", x), ("b", b), ("c", c), ("dy", dy),
                    ("dfinal", dfinal), ("init", init)):
        ss._check_aligned(fn, name, t)
    assert (b.data_ptr() - x.data_ptr(), c.data_ptr() - x.data_ptr()) == (
        4 * 64 * 2, (4 * 64 + 128) * 2)

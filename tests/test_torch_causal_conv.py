"""Mamba-2's depthwise causal conv (``kernels/causal_conv.py``): the plain
version against the JAX package's ``_causal_conv``; its gradient written
out (``causal_conv_bwd_plain``, the arithmetic of ``csrc/causal_conv.cu``)
against torch autograd through the plain version and against ``jax.vjp``,
with and without a conv state, at widths 2 to 4 and on a strided view of an
``in_proj``-shaped output; the ``CausalConv`` autograd Function's glue with
the CUDA wrappers swapped for plain stand-ins; the ops on meta tensors;
the wrappers' refusals; ``mamba2_block`` on the CPU unchanged bit for bit;
the load width the wrapper picks; the ``ssm.conv`` span's launch count;
the plain renderings of the faults ``chip_smoke.py`` holds the kernels'
bar against; and the byte bound.

Bars, each relative to max |reference|: float32 1e-5 (the same function
summed in another order); bfloat16 2e-2 (the plain version rounds every
product and partial sum to bf16, the written-out gradient only its
outputs: about a bf16 ulp of the largest value).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.models import ssm as rssm  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import causal_conv as cc  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.layers import COMPUTE_DTYPE, ParamBuilder  # noqa: E402

F32_BAR = 1e-5
BF16_BAR = 2e-2
NAMES = ("dx", "dw", "db", "dstate")


def _inputs(B, S, C, W, seed=0, strided=False):
    """x (a column slice of a wider row where ``strided``, as the model's
    ``xbc``), w, b, the state and dy as float32 numpy arrays, with the
    slice's offset and row width."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    off, row = (5, C + 11) if strided else (0, C)
    return {"row": rng.standard_normal((B, S, row)).astype(f32),
            "off": off,
            "w": (0.5 * rng.standard_normal((W, C))).astype(f32),
            "b": (0.5 * rng.standard_normal((C,))).astype(f32),
            "state": rng.standard_normal((B, W - 1, C)).astype(f32),
            "dy": rng.standard_normal((B, S, C)).astype(f32)}


def _torch(arr, dtype, with_state):
    """(x, w, b, state, dy) in ``dtype``, x a view into its row."""
    C = arr["w"].shape[1]
    row = torch.tensor(arr["row"]).to(dtype)
    x = row[..., arr["off"]:arr["off"] + C]
    w, b, dy = (torch.tensor(arr[k]).to(dtype) for k in ("w", "b", "dy"))
    state = torch.tensor(arr["state"]).to(dtype) if with_state else None
    return x, w, b, state, dy


def _rel(got, want):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(g, np.float32) - w).max()
                 / np.abs(w).max())


CASES = [(with_state, W, strided) for with_state in (False, True)
         for W in (2, 3, 4) for strided in (False, True)]
IDS = [f"{'state' if s else 'zeros'}-w{W}-{'view' if v else 'dense'}"
       for s, W, v in CASES]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_matches_the_jax_conv(with_state, dtype):
    arr = _inputs(2, 40, 24, 4, seed=1)
    td, jd = ((torch.float32, jnp.float32) if dtype == "f32"
              else (torch.bfloat16, jnp.bfloat16))
    x, w, b, state, _ = _torch(arr, td, with_state)
    got = cc.causal_conv_plain(x, w, b, state)
    assert got.dtype == td and got.shape == x.shape
    want = rssm._causal_conv(
        jnp.asarray(arr["row"], jd), jnp.asarray(arr["w"], jd),
        jnp.asarray(arr["b"], jd),
        jnp.asarray(arr["state"], jd) if with_state else None)
    assert _rel(got, np.asarray(want, np.float32)) <= (
        1e-6 if dtype == "f32" else BF16_BAR)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd(case, dtype):
    with_state, W, strided = case
    arr = _inputs(2, 48, 16, W, seed=2, strided=strided)
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    x, w, b, state, dy = _torch(arr, td, with_state)
    got = cc.causal_conv_bwd_plain(x, w, b, state, dy)
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, w, b) + ((state,) if with_state else ())]
    y = cc.causal_conv_plain(*leaves[:3], leaves[3] if with_state else None)
    want = torch.autograd.grad(y, leaves, dy)
    bar = F32_BAR if dtype == "f32" else BF16_BAR
    for name, g, r in zip(NAMES, got, want):
        assert g.dtype == r.dtype == td and g.shape == r.shape, name
        assert _rel(g, r.float().numpy()) <= bar, (name, _rel(g, r.float()))
    if not with_state:
        assert got[3] is None


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case):
    with_state, W, strided = case
    arr = _inputs(2, 48, 16, W, seed=3, strided=strided)
    C = arr["w"].shape[1]
    x, w, b, state, dy = _torch(arr, torch.float32, with_state)
    got = cc.causal_conv_bwd_plain(x, w, b, state, dy)
    xj = jnp.asarray(arr["row"])[..., arr["off"]:arr["off"] + C]
    primals = [xj, jnp.asarray(arr["w"]), jnp.asarray(arr["b"])]
    if with_state:
        primals.append(jnp.asarray(arr["state"]))
    _, vjp = jax.vjp(lambda *a: rssm._causal_conv(*a), *primals)
    want = vjp(jnp.asarray(arr["dy"]))
    for name, g, r in zip(NAMES, got, want):
        assert _rel(g, np.asarray(r)) <= F32_BAR, name


def _plain_wrappers(calls):
    """Stand-ins for the two CUDA wrappers with their contracts, from the
    plain versions in float32 (the kernels' arithmetic): y and dx in bf16,
    dw and db in w's and b's dtypes, dstate float32 (empty without a
    state)."""

    def f32(t):
        return None if t is None else t.float()

    def fwd(x, w, b, state=None):
        calls.append(("fwd", state is not None))
        return cc.causal_conv_plain(x.float(), w.float(), b.float(),
                                    f32(state)).to(x.dtype)

    def bwd(x, w, b, state, dy):
        calls.append(("bwd", state is not None))
        assert dy.shape == x.shape and dy.stride(-1) == 1
        dx, dw, db, ds = cc.causal_conv_bwd_plain(
            x.float(), w.float(), b.float(), f32(state), dy.float())
        return (dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype),
                torch.empty(0) if ds is None else ds)

    return fwd, bwd


@pytest.mark.parametrize("with_state", [False, True])
def test_causalconv_function_glue(with_state, monkeypatch):
    """``CausalConv`` with the CUDA wrappers swapped for plain stand-ins, on
    the CPU: the forward hands its operands over, the backward the saved
    ones and dy (made contiguous where autograd hands over an expanded
    one), and the gradients, in the inputs' dtypes (the state's float32),
    equal autograd's through the plain version."""
    calls = []
    fwd, bwd = _plain_wrappers(calls)
    monkeypatch.setattr(cc, "causal_conv_cuda", fwd)
    monkeypatch.setattr(cc, "causal_conv_bwd_cuda", bwd)
    arr = _inputs(2, 64, 24, 4, seed=4, strided=True)
    x, w, b, _, dy = _torch(arr, torch.bfloat16, False)
    state = torch.tensor(arr["state"]) if with_state else None

    def leaves():
        return [t.detach().clone().requires_grad_()
                for t in (x, w, b) + ((state,) if with_state else ())]

    got = leaves()
    y = cc.CausalConv.apply(*got[:3], got[3] if with_state else None)
    (y.float() * dy.float()).sum().backward()
    assert calls == [("fwd", with_state), ("bwd", with_state)]
    want = leaves()
    y2 = cc.causal_conv_plain(*want[:3], want[3] if with_state else None)
    (y2.float() * dy.float()).sum().backward()
    assert _rel(y, y2.detach().float().numpy()) <= BF16_BAR
    for g, r in zip(got, want):
        assert g.grad.dtype == r.dtype and g.grad.shape == r.shape
        assert _rel(g.grad, r.grad.float().numpy()) <= BF16_BAR
    # An expanded cotangent (y.sum()) reaches the wrapper contiguous.
    got = leaves()
    cc.CausalConv.apply(*got[:3], got[3] if with_state else None) \
        .float().sum().backward()
    assert calls[-1] == ("bwd", with_state)


def _meta(t):
    return tuple(t.shape), t.dtype


@pytest.mark.parametrize("with_state", [False, True])
def test_ops_on_meta_tensors_launch_nothing(with_state):
    """The dispatcher sends meta tensors (the dry-run's) to the ops, whose
    fake implementations give the shapes of the plain version's outputs
    and gradients; nothing launches."""
    B, S, C, W = 2, 40, 24, 4

    def make(*shape, grad=True):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta",
                           requires_grad=grad)

    x, w, b = make(B, S, C), make(W, C), make(C)
    state = make(B, W - 1, C) if with_state else None
    before = cc.launches()
    y = cc.causal_conv_kernel(x, w, b, state)
    grads = torch.autograd.grad(y, [t for t in (x, w, b, state)
                                    if t is not None], torch.empty_like(y))
    assert cc.launches() == before
    assert _meta(y) == ((B, S, C), torch.bfloat16) and y.device.type == "meta"
    assert [_meta(g) for g in grads] == [_meta(t) for t in (x, w, b, state)
                                         if t is not None]
    with torch.no_grad():
        assert _meta(cc.causal_conv_kernel(x, w, b, state)) == _meta(y)
    assert cc.launches() == before


def _op_inputs():
    def make(shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    row = make((2, 40, 40))
    x = row[..., 8:32]
    w, b, state, dy = make((4, 24)), make((24,)), make((2, 3, 24)), \
        make((2, 40, 24))
    return {"causal_conv": (x, w, b, state),
            "causal_conv_bwd": (x, w, b, None, dy)}


@pytest.mark.parametrize("name", ["causal_conv", "causal_conv_bwd"])
def test_opcheck_on_shapes(name):
    """``opcheck``'s schema, autograd-registration and fake-tensor checks on
    meta inputs (the card checks the CUDA implementation)."""
    torch.library.opcheck(getattr(torch.ops.repro_torch, name),
                          _op_inputs()[name],
                          test_utils=("test_schema",
                                      "test_autograd_registration",
                                      "test_faketensor"))


def test_wrappers_refuse_host_tensors():
    arr = _inputs(1, 16, 8, 4)
    x, w, b, state, dy = _torch(arr, torch.bfloat16, True)
    before = cc.launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        cc.causal_conv_cuda(x, w, b, state)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cc.causal_conv_bwd_cuda(x, w, b, state, dy)
    assert cc.launches() == before


@pytest.mark.parametrize("fault", ["wide", "float32", "strided", "state"])
def test_wrappers_refuse_what_the_kernels_do_not_take(fault):
    """Widths above MAX_WIDTH, other dtypes than bf16, a non-unit last
    stride and a misshapen state raise on meta tensors too."""
    def make(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    x, w, b, state = make(1, 16, 8), make(4, 8), make(8), None
    if fault == "wide":
        w = make(cc.MAX_WIDTH + 1, 8)
    elif fault == "float32":
        x = make(1, 16, 8, dtype=torch.float32)
    elif fault == "strided":
        x = make(1, 16, 16)[..., ::2]
    else:
        state = make(1, 4, 8)
    with pytest.raises((ValueError, TypeError)):
        cc.causal_conv_cuda(x, w, b, state)


def _old_causal_conv(x, w, b, state=None):
    """``models/ssm.py::_causal_conv`` before the kernel, verbatim."""
    W = w.shape[0]
    if state is None:
        x_pad = F.pad(x, (0, 0, W - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = sum(x_pad[:, i:i + S, :] * w[i] for i in range(W))
    return F.silu((out + b).float()).to(x.dtype)


def _block_run(cfg, params, x, ct, state):
    """The block's output (and new state), and every gradient of a
    cotangent through it."""
    leaves, spec = pytree.tree_flatten(params)
    live = [t.detach().clone().requires_grad_() for t in leaves]
    xg = x.clone().requires_grad_()
    out = ssm.mamba2_block(pytree.tree_unflatten(live, spec), xg, cfg,
                           state=state, return_state=state is not None)
    y = out[0] if state is not None else out
    grads = torch.autograd.grad((y.float() * ct).sum(), [xg] + live)
    return out, grads


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_block_on_the_cpu_is_unchanged(with_state, monkeypatch):
    """On the CPU ``mamba2_block`` computes what it computed before the
    kernel, bit for bit: output, new state and gradients, from zeros and
    from a conv state."""
    cfg = get_config("mamba2-370m").reduced()
    params = ssm.init_mamba2(ParamBuilder(7, "cpu"), cfg)
    g = torch.Generator().manual_seed(8)
    x = torch.randn((2, 24, cfg.d_model), generator=g).to(COMPUTE_DTYPE)
    ct = torch.randn((2, 24, cfg.d_model), generator=g)
    state = None
    if with_state:
        conv, ssm_state = ssm.init_mamba2_state(cfg, 2)
        state = (torch.randn(conv.shape, generator=g).to(conv.dtype),
                 torch.randn(ssm_state.shape, generator=g))
    new, new_grads = _block_run(cfg, params, x, ct, state)
    monkeypatch.setattr(ssm, "causal_conv_kernel", _old_causal_conv)
    old, old_grads = _block_run(cfg, params, x, ct, state)
    assert all(torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(new), pytree.tree_leaves(old)))
    assert all(torch.equal(a, b) for a, b in zip(new_grads, old_grads))


def test_vector_width_follows_pointers_and_strides():
    """The load width the wrapper picks: 4 channels (8 bytes) for
    granite-4.0-h-micro's and mamba2-370m's ``xbc`` views (offsets 8,192
    and 4,096 bytes, rows of 17,024 and 8,768), narrower where the base,
    a stride or the channel count allows no more."""
    granite = torch.empty((1, 4, 8512), dtype=torch.bfloat16)
    assert cc.vector_width(granite[..., 4096:8448]) == 4
    mamba2 = torch.empty((2, 4, 4384), dtype=torch.bfloat16)
    assert cc.vector_width(mamba2[..., 2048:4352]) == 4
    assert cc.vector_width(granite[..., 4098:8450]) == 2
    assert cc.vector_width(granite[..., 4097:8449]) == 1
    odd_row = torch.empty((1, 4, 8514), dtype=torch.bfloat16)
    assert cc.vector_width(odd_row[..., 4096:8448]) == 2
    assert cc.vector_width(torch.empty((1, 4, 6), dtype=torch.bfloat16)) == 2
    assert cc.vector_width(granite[..., 4096:8448],
                           torch.empty((1, 4, 4352),
                                       dtype=torch.bfloat16)[..., 1:]) == 1


def test_conv_span_counts_the_kernels_launches(monkeypatch):
    """``ssm.conv`` carries ``launches``: 0 on the plain path, and the conv
    kernels' calls inside it where the block takes them (here a counting
    stand-in), one a block call."""
    cfg = get_config("mamba2-370m").reduced()
    params = ssm.init_mamba2(ParamBuilder(3, "cpu"), cfg)
    x = torch.randn((1, 8, cfg.d_model)).to(COMPUTE_DTYPE)

    def counted(*args):
        cc.causal_conv_cuda.launches += 1
        return cc.causal_conv_plain(*args)

    def conv_spans():
        spans.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            ssm.mamba2_block(params, x, cfg)
        return [r.attrs for r in spans.records() if r.name == "ssm.conv"]

    assert conv_spans() == [{"launches": 0}]
    monkeypatch.setattr(ssm, "causal_conv_kernel", counted)
    monkeypatch.setattr(cc.causal_conv_cuda, "launches",
                        cc.causal_conv_cuda.launches)
    assert conv_spans() == [{"launches": 1}]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("with_state", [False, True])
def test_fault_renderings_exceed_the_bar(with_state):
    """The plain renderings of the faults phase "causal conv" shows (a
    window one step into the future, the oldest tap dropped, the bias left
    out, SiLU's derivative left out of the gradient) each read above
    ``CONV_BAR`` at a small shape, where the plain version run twice reads
    0."""
    cs = _chip_smoke()
    arr = _inputs(2, 64, 24, cs.CONV_WIDTH, seed=6, strided=True)
    x, w, b, state, dy = _torch(arr, torch.float32, with_state)
    want = cc.causal_conv_plain(x, w, b, state)
    grads = cc.causal_conv_bwd_plain(x, w, b, state, dy)
    faults = cs.conv_faults(cc, torch, x, w, b, state, dy, want, grads)
    assert set(faults) == {"anti-causal shift", "dropped tap",
                           "missing bias", "silu derivative dropped"}
    readings = [e for pair in faults.values() for e in pair if e is not None]
    assert len(readings) == 7 and min(readings) > cs.CONV_BAR
    assert cs.norm_err(cc.causal_conv_plain(x, w, b, state), want) == 0.0


def test_conv_bytes_and_partial_rows():
    """The byte bounds counted by hand at granite-4.0-h-micro's training
    shape (B 1, S 16,384, C 4,352): x and y, 285 MB; x, dy and dx, 428 MB;
    and the backward's partial rows, one a block of BLOCK_ROWS steps."""
    assert cc.conv_bytes(1, 16384, 4352) == 2 * 16384 * 4352 * 2 \
        == 285_212_672
    assert cc.conv_bytes(1, 16384, 4352, backward=True) == 427_819_008
    assert cc.bwd_partial_rows(1, 16384) == 16384 // cc.BLOCK_ROWS
    assert cc.bwd_partial_rows(8, 2048) == 8 * 2048 // cc.BLOCK_ROWS
    assert cc.bwd_partial_rows(2, cc.BLOCK_ROWS + 1) == 4


CONV_PTXAS = """\
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9f1e3a6b_14_causal_conv_cu_2c5d8e1b17causal_conv1d_fwdILi4ELi4EEEvNS_10ConvParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__9f1e3a6b_14_causal_conv_cu_2c5d8e1b17causal_conv1d_fwdILi4ELi4EEEvNS_10ConvParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 108 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9f1e3a6b_14_causal_conv_cu_2c5d8e1b20causal_conv1d_bwd_dxILi4ELi4EEEvNS_10ConvParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__9f1e3a6b_14_causal_conv_cu_2c5d8e1b20causal_conv1d_bwd_dxILi4ELi4EEEvNS_10ConvParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9f1e3a6b_14_causal_conv_cu_2c5d8e1b20causal_conv1d_bwd_dwEPKfllP13__nv_bfloat16S4_' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__9f1e3a6b_14_causal_conv_cu_2c5d8e1b20causal_conv1d_bwd_dwEPKfllP13__nv_bfloat16S4_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, used 1 barriers
"""


def test_ptxas_table_reads_the_conv_kernels():
    """Phase "build" names the conv's kernels with their width and load
    (as ``chip_smoke.CONV_KERNELS`` names them), the sum's without
    template arguments."""
    cs = _chip_smoke()
    rows = cs.ptxas_table(CONV_PTXAS)
    assert [(r["kernel"], r["args"], r["registers"]) for r in rows] == [
        ("causal_conv1d_fwd", "4, 4", 108),
        ("causal_conv1d_bwd_dx", "4, 4", 122),
        ("causal_conv1d_bwd_dw", "", 26)]
    assert {r["kernel"] for r in rows} == set(cs.CONV_KERNELS)

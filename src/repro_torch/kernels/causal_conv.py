"""Mamba-2's depthwise causal conv, its bias and its SiLU as CUDA kernels,
forward and backward.

``models/ssm.py::mamba2_block`` runs the conv once per layer on the
(x, B, C) columns of ``in_proj``'s output (``xbc``), a strided view:

    y[b, t, c] = silu(bias[c] + sum_i w[i, c] x[b, t + i - (W - 1), c])

with x at times -(W - 1) .. -1 the conv state ``[B, W - 1, C]`` where one
is given (a continued prefill), else zero.  ``csrc/causal_conv.cu``
replaces no Pallas kernel: the JAX package's ``models/ssm.py::
_causal_conv`` leaves the conv to XLA, which fuses its shifted
multiply-adds into one pass.  Eager torch ran the same code as ~12 passes
over the strided view in the forward and ~20 in autograd's backward,
several of them float32.  The kernels move what the work needs: the
forward reads x and writes y (2 x B S C x 2 bytes), the backward reads x
and dy and writes dx (3 x B S C x 2 bytes); the weights and their
gradients are a few kilobytes (:func:`conv_bytes`).  Their design is in
the source's header.

Functions:

* :func:`causal_conv_plain` — the model's conv as it was, operation for
  operation (the CPU path, equal to the JAX package's ``_causal_conv``);
* :func:`causal_conv_bwd_plain` — its gradient written out formula for
  formula in float32 (:func:`conv_bwd_from_g` is the part after SiLU's
  derivative);
* :func:`causal_conv_cuda`, :func:`causal_conv_bwd_cuda` — the kernels'
  wrappers, the ``torch.library`` ops ``repro_torch::causal_conv`` and
  ``repro_torch::causal_conv_bwd``, whose fake implementations launch
  nothing (no FLOP formula: element-wise work); each counts its calls in
  ``.launches`` (the backward's two launches as one call);
* :class:`CausalConv` — the ``torch.autograd.Function`` around the two;
* :func:`causal_conv_kernel` — the dispatcher: a CPU tensor goes to the
  plain version (autograd differentiates it), a CUDA or meta tensor to the
  kernels.

The kernels compute the taps, the bias and the SiLU (and its derivative)
in float32 and round each output to bf16 once, where the plain version
rounds every product and partial sum to bf16: at least the configuration's
precision.  Loads are 8 bytes (4 channels) where the view allows;
:func:`vector_width` picks a narrower load from the pointers and strides
where it does not.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import OP_DEVICES, build, refuse_dtensor
from repro_torch.kernels.flash_attention import LIBRARY

#: The widest conv the kernels are compiled for (``kMaxWidth``); every
#: preset's ``conv_width`` is 4.
MAX_WIDTH = 4
#: Time steps a backward block covers (``kBwdBlockRows``): it writes one
#: float32 partial row of dw and db, B * ceil(S / BLOCK_ROWS) rows in all.
BLOCK_ROWS = 128
#: Channels a load, widest first (8, 4, 2 bytes of bf16; ``csrc/
#: causal_conv.cu`` says why not 16).
VECTOR_WIDTHS = (4, 2, 1)


# ---------------------------------------------------------------------------
# The plain versions.
# ---------------------------------------------------------------------------


def causal_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  x: [B, S, Cdim]; w: [W, Cdim].
    ``state``: [B, W-1, Cdim] trailing context; None => zero-pad."""
    W = w.shape[0]
    if state is None:
        x_pad = F.pad(x, (0, 0, W - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = sum(x_pad[:, i:i + S, :] * w[i] for i in range(W))
    return F.silu((out + b).float()).to(x.dtype)


def conv_bwd_from_g(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    state: Optional[torch.Tensor] = None):
    """(dx, dw, db, dstate) in float32 from g = dL/du, the cotangent of the
    pre-activation u = bias + sum_i w[i] x[t + i - (W - 1)]:
    dx[t] = sum_i w[i] g[t - i + W - 1] (g zero from S on; dstate the same
    at t = -(W - 1) .. -1, None without a state), dw[i] = sum_{b,t} g[t]
    x[t + i - (W - 1)], db = sum_{b,t} g[t]."""
    W, S = w.shape[0], x.shape[1]
    x_pad = _padded(x, state, W).float()
    wf = w.float()
    # Each tap's share of dx, placed where its x sits in x_pad.
    dxp = sum(F.pad(g * wf[i], (0, 0, i, W - 1 - i)) for i in range(W))
    dw = torch.stack([(g * x_pad[:, i:i + S]).sum(dim=(0, 1))
                      for i in range(W)])
    db = g.sum(dim=(0, 1))
    return (dxp[:, W - 1:], dw, db,
            None if state is None else dxp[:, :W - 1])


def causal_conv_bwd_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          state: Optional[torch.Tensor], dy: torch.Tensor):
    """The gradient of :func:`causal_conv_plain` written out formula for
    formula in float32 (no autograd): the cotangent ``dy`` of y gives
    ``(dx, dw, db, dstate)``, each in its input's dtype (dstate None where
    ``state`` is None).  It is the arithmetic of ``csrc/causal_conv.cu``::

        u = bias + sum_i w[i] x[t + i - (W - 1)],   s = sigmoid(u)
        g = dy s (1 + u (1 - s))                    (SiLU's derivative)

    then :func:`conv_bwd_from_g`."""
    W, S = w.shape[0], x.shape[1]
    x_pad = _padded(x, state, W).float()
    wf = w.float()
    u = sum(x_pad[:, i:i + S] * wf[i] for i in range(W)) + b.float()
    s = torch.sigmoid(u)
    g = dy.float() * s * (1 + u * (1 - s))
    dx, dw, db, dstate = conv_bwd_from_g(g, x, w, state)
    return (dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype),
            None if state is None else dstate.to(state.dtype))


def _padded(x: torch.Tensor, state: Optional[torch.Tensor],
            W: int) -> torch.Tensor:
    """x after the state's W - 1 rows (in x's dtype), or after W - 1 zero
    rows, as :func:`causal_conv_plain` pads it."""
    if state is None:
        return F.pad(x, (0, 0, W - 1, 0))
    return torch.cat([state.to(x.dtype), x], dim=1)


# ---------------------------------------------------------------------------
# Sizes.
# ---------------------------------------------------------------------------


def conv_bytes(B: int, S: int, C: int, backward: bool = False) -> int:
    """Bytes the conv must move: x read and y written (forward), x and dy
    read and dx written (backward), bf16; the weights and their gradients
    (a few kilobytes) left out."""
    return (3 if backward else 2) * B * S * C * 2


def bwd_partial_rows(B: int, S: int) -> int:
    """Partial rows of dw and db the backward writes: one a block of
    :data:`BLOCK_ROWS` time steps, per batch row."""
    return B * -(-S // BLOCK_ROWS)


def vector_width(*tensors: torch.Tensor) -> int:
    """The widest load, in bf16 channels (4, 2 or 1), that every row of
    ``tensors`` allows: each one's first element, every stride but the
    last (which is 1) and the channel count multiples of it."""
    for v in VECTOR_WIDTHS:
        if all(t.data_ptr() % (2 * v) == 0 and t.shape[-1] % v == 0
               and not any(s % v for s in t.stride()[:-1])
               for t in tensors):
            return v
    return 1


# ---------------------------------------------------------------------------
# The CUDA kernels, as operators of torch's dispatcher.
# ---------------------------------------------------------------------------


def _library():
    """The built kernel library with its C signatures declared."""
    lib = build.load("causal_conv")
    if not getattr(lib, "_causal_conv_typed", False):
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.causal_conv_block_rows.argtypes = []
        lib.causal_conv_block_rows.restype = i64
        lib.causal_conv_max_width.argtypes = []
        lib.causal_conv_max_width.restype = ctypes.c_int
        lib.causal_conv_fwd_launch.argtypes = [
            ptr, i64, i64, ptr, ptr, ptr, ptr, i64, i64, i64, ctypes.c_int,
            ctypes.c_int, ptr]
        lib.causal_conv_fwd_launch.restype = ctypes.c_int
        lib.causal_conv_bwd_launch.argtypes = [
            ptr, i64, i64, ptr, ptr, ptr, ptr, i64, i64, ptr, ptr, ptr, ptr,
            ptr, i64, i64, i64, ctypes.c_int, ctypes.c_int, ptr]
        lib.causal_conv_bwd_launch.restype = ctypes.c_int
        lib.causal_conv_error_string.argtypes = [ctypes.c_int]
        lib.causal_conv_error_string.restype = ctypes.c_char_p
        if (lib.causal_conv_block_rows() != BLOCK_ROWS
                or lib.causal_conv_max_width() != MAX_WIDTH):
            raise RuntimeError(
                "csrc/causal_conv.cu covers "
                f"{lib.causal_conv_block_rows()} rows a block up to width "
                f"{lib.causal_conv_max_width()}, kernels/causal_conv.py "
                f"{BLOCK_ROWS} and {MAX_WIDTH}")
        lib._causal_conv_typed = True
    return lib


def _check_operands(fn: str, x, w, b, state, dy=None) -> tuple:
    """Device, dtype, rank and shape of the operands, and a unit last
    stride where the kernels read rows of x and dy in place; returns
    (B, S, C, W)."""
    if not isinstance(x, torch.Tensor) or x.device.type not in OP_DEVICES:
        raise ValueError(f"{fn} takes CUDA tensors; x is on "
                         f"{getattr(x, 'device', type(x).__name__)}")
    dev = x.device
    named = [("x", x, 3), ("w", w, 2), ("b", b, 1)]
    if dy is not None:
        named.append(("dy", dy, 3))
    for name, t, dims in named:
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{fn}: {name} is on "
                             f"{getattr(t, 'device', type(t).__name__)}, x on "
                             f"{dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{fn} takes bfloat16 {name}, got {t.dtype}")
        if t.dim() != dims:
            raise ValueError(f"{fn}: {name} must be {dims}-D, got "
                             f"{tuple(t.shape)}")
    B, S, C = x.shape
    W = w.shape[0]
    if not 1 <= W <= MAX_WIDTH or w.shape[1] != C or b.shape != (C,):
        raise ValueError(f"{fn}: w {tuple(w.shape)} and b {tuple(b.shape)} "
                         f"are not [W, C] (W 1 to {MAX_WIDTH}) and [C] for x "
                         f"{tuple(x.shape)}")
    for name, t in (("x", x), ("dy", dy)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f"{fn}: {name} needs a unit last stride, got "
                             f"strides {t.stride()}")
    if dy is not None and dy.shape != x.shape:
        raise ValueError(f"{fn}: dy {tuple(dy.shape)} must be shaped as x "
                         f"{tuple(x.shape)}")
    if state is not None:
        if not isinstance(state, torch.Tensor) or state.device != dev:
            raise ValueError(f"{fn}: state is on "
                             f"{getattr(state, 'device', None)}, x on {dev}")
        if state.shape != (B, W - 1, C) or not state.is_floating_point():
            raise ValueError(f"{fn}: state {state.dtype} "
                             f"{tuple(state.shape)} is not a floating "
                             f"[B, W - 1, C] = {(B, W - 1, C)}")
    return B, S, C, W


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"causal_conv {what} kernel launch failed: "
                           + lib.causal_conv_error_string(rc).decode())


def _state_bf16(state: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The state as the kernels read it: bf16 (the plain version's cast to
    x's dtype), contiguous."""
    return None if state is None else state.to(torch.bfloat16).contiguous()


def _causal_conv_launch(x, w, b, state):
    """``repro_torch::causal_conv`` on the card: one launch, on operands
    :func:`causal_conv_cuda` has checked."""
    B, S, C = x.shape
    y = torch.empty((B, S, C), dtype=torch.bfloat16, device=x.device)
    if y.numel() == 0:
        return y
    w, b, state = w.contiguous(), b.contiguous(), _state_bf16(state)
    rows = [x, w, b, y] + ([state] if state is not None else [])
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise(lib, lib.causal_conv_fwd_launch(
            x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(),
            b.data_ptr(), None if state is None else state.data_ptr(),
            y.data_ptr(), B, S, C, w.shape[0], vector_width(*rows), stream),
            "forward")
    causal_conv_cuda.launches += 1
    return y


def _causal_conv_fake(x, w, b, state):
    B, S, C, _ = _check_operands("causal_conv_cuda", x, w, b, state)
    return x.new_empty((B, S, C))


def _bwd_outputs(x, w, b, state):
    """The backward's outputs as the launch allocates them: dx [B, S, C]
    bf16, dw and db in w's and b's shapes and dtypes, dstate [B, W - 1, C]
    float32 (empty without a state)."""
    B, S, C = x.shape
    dx = torch.empty((B, S, C), dtype=torch.bfloat16, device=x.device)
    dw = torch.empty(tuple(w.shape), dtype=w.dtype, device=x.device)
    db = torch.empty(tuple(b.shape), dtype=b.dtype, device=x.device)
    dstate = torch.empty((B, w.shape[0] - 1, C) if state is not None
                         else (0,), dtype=torch.float32, device=x.device)
    return dx, dw, db, dstate


def _causal_conv_bwd_launch(x, w, b, state, dy):
    """``repro_torch::causal_conv_bwd`` on the card: two launches, on
    operands :func:`causal_conv_bwd_cuda` has checked."""
    B, S, C = x.shape
    W = w.shape[0]
    out = _bwd_outputs(x, w, b, state)
    dx, dw, db, dstate = out
    if dx.numel() == 0:
        for t in (dw, db, dstate):
            t.zero_()
        return out
    w, b, state = w.contiguous(), b.contiguous(), _state_bf16(state)
    partials = torch.empty((bwd_partial_rows(B, S), W + 1, C),
                           dtype=torch.float32, device=x.device)
    rows = [x, w, b, dy, dx] + ([state] if state is not None else [])
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise(lib, lib.causal_conv_bwd_launch(
            x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(),
            b.data_ptr(), None if state is None else state.data_ptr(),
            dy.data_ptr(), dy.stride(0), dy.stride(1), dx.data_ptr(),
            dstate.data_ptr() if state is not None else None,
            partials.data_ptr(), dw.data_ptr(), db.data_ptr(), B, S, C, W,
            vector_width(*rows), stream), "backward")
    causal_conv_bwd_cuda.launches += 1
    return out


def _causal_conv_bwd_fake(x, w, b, state, dy):
    _check_operands("causal_conv_bwd_cuda", x, w, b, state, dy)
    return _bwd_outputs(x, w, b, state)


LIBRARY.define("causal_conv(Tensor x, Tensor w, Tensor b, Tensor? state) "
               "-> Tensor")
LIBRARY.define("causal_conv_bwd(Tensor x, Tensor w, Tensor b, "
               "Tensor? state, Tensor dy) -> (Tensor, Tensor, Tensor, "
               "Tensor)")
LIBRARY.impl("causal_conv", _causal_conv_launch, "CUDA")
LIBRARY.impl("causal_conv_bwd", _causal_conv_bwd_launch, "CUDA")
torch.library.register_fake("repro_torch::causal_conv", _causal_conv_fake,
                            lib=LIBRARY)
torch.library.register_fake("repro_torch::causal_conv_bwd",
                            _causal_conv_bwd_fake, lib=LIBRARY)


def causal_conv_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/causal_conv.cu``'s forward (the op
    ``repro_torch::causal_conv``): x ``[B, S, C]`` bfloat16 with a unit last
    stride (any other strides: the model passes a column slice of
    ``in_proj``'s output, read in place), w ``[W, C]`` and b ``[C]``
    bfloat16, W 1 to :data:`MAX_WIDTH`, ``state`` ``[B, W - 1, C]`` (cast to
    bf16) or None (zeros).  Returns y ``[B, S, C]`` bf16, contiguous, still
    being computed on the current stream.  Builds the kernel with ``nvcc``
    at first use.  Raises on any other input and if the launch is refused.
    A fake or meta tensor runs the op's fake implementation: shapes only,
    nothing launched."""
    _check_operands("causal_conv_cuda", x, w, b, state)
    return torch.ops.repro_torch.causal_conv.default(x, w, b, state)


causal_conv_cuda.launches = 0


def causal_conv_bwd_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         state: Optional[torch.Tensor], dy: torch.Tensor):
    """Launch ``csrc/causal_conv.cu``'s backward (the op
    ``repro_torch::causal_conv_bwd``: dx and the partial sums of dw and db,
    then their sum in a fixed order): x, w, b and ``state`` as
    :func:`causal_conv_cuda` takes them, dy ``[B, S, C]`` bfloat16 with a
    unit last stride.  Returns ``(dx, dw, db, dstate)`` as
    :func:`causal_conv_bwd_plain` computes them, dx bf16 contiguous, dw and
    db in w's and b's dtypes, dstate float32 ``[B, W - 1, C]`` (empty
    without a state), still being computed on the current stream.  Counts
    one launch per call in ``causal_conv_bwd_cuda.launches``.  Raises on
    any other input and if a launch is refused."""
    _check_operands("causal_conv_bwd_cuda", x, w, b, state, dy)
    return torch.ops.repro_torch.causal_conv_bwd.default(x, w, b, state, dy)


causal_conv_bwd_cuda.launches = 0


def launches() -> int:
    """The calls of both wrappers so far (a backward's two kernel launches
    count once)."""
    return causal_conv_cuda.launches + causal_conv_bwd_cuda.launches


class CausalConv(torch.autograd.Function):
    """The conv on the card with a gradient: the forward kernel, then the
    backward kernel from the saved operands (x is a view of ``in_proj``'s
    output, which autograd keeps anyway).  The gradient is the JAX
    package's ``jax.grad`` of the same function (``_causal_conv``).
    Gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, w, b, state):
        y = causal_conv_cuda(x, w, b, state)
        ctx.save_for_backward(x, w, b, state)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, b, state = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        dx, dw, db, dstate = causal_conv_bwd_cuda(x, w, b, state, dy)
        return dx, dw, db, (None if state is None
                            else dstate.to(state.dtype))


def causal_conv_kernel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv on x's device: a CPU tensor is computed by
    :func:`causal_conv_plain` (autograd differentiates it), a CUDA tensor
    by the CUDA kernel: through :class:`CausalConv` and its backward kernel
    where grad is enabled and an input requires it, else the forward alone.
    A meta tensor takes the kernels' custom ops as a CUDA tensor does,
    which run their fake implementations.  A DTensor input raises."""
    refuse_dtensor("causal_conv_kernel", x, w, b, state)
    if x.device.type == "cpu":
        return causal_conv_plain(x, w, b, state)
    if x.device.type in OP_DEVICES:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x, w, b, state)):
            return CausalConv.apply(x, w, b, state)
        return causal_conv_cuda(x, w, b, state)
    raise ValueError(f"no causal_conv for device {x.device}")

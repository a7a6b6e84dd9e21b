"""The Mamba2 SSD chunked scan as a CUDA kernel.

Prefill hot spot of the ssm family: ``models/ssm.py::ssd_chunked`` calls
:func:`ssd_scan_kernel` once per layer.  The hand-written kernel in
``csrc/ssd_scan.cu`` replaces the JAX package's Pallas TPU kernel
``repro/kernels/ssd_scan.py::_kernel``, launched there by ``ssd_scan``.

The contract is the model's ``ssd_chunked`` (``models/ssm.py:79-142`` of
the reference): x ``[B, S, H, P]``, dt ``[B, S, H]`` (already softplus'd),
a ``[H]`` (negative), b/c ``[B, S, N]`` (one group shared by every head),
an optional float32 ``init_state [B, H, P, N]``; returns
``(y [B, S, H, P] in x's dtype, final_state [B, H, P, N] float32)``.
Per head, with state ``s`` of shape ``[P, N]``::

    s_t = exp(dt_t a) s_{t-1} + dt_t x_t b_tᵀ,     y_t = s_t c_t

The D-skip term stays outside, in ``mamba2_block``.

The chunked dual form is exact algebra for any chunk length (the JAX
package's ``tests/test_layers.py`` checks chunk invariance), so the CUDA
kernel takes its own chunk of :data:`KERNEL_CHUNK` tokens whatever
``chunk`` the caller names: a ``[256, 256]`` float32 score tile would not
fit a block's shared memory.  The plain version uses ``chunk``.

Three functions compute it:

* :func:`ssd_scan_plain` — ``ssd_chunked`` in plain torch (any device);
* :func:`ssd_scan_cuda` — the CUDA kernel's wrapper, CUDA tensors only
  (x/b/c bfloat16, dt/a float32).  The kernel is compiled for
  (P, N) = (64, 128); the wrapper zero-pads a smaller P or N up to it
  (:func:`pad_shape`) and slices y and the final state back, which is
  exact: zero columns of x give zero rows of the state and of y, and zero
  columns of b and c add nothing to C Bᵀ or to C s.  It counts its launches
  in ``ssd_scan_cuda.launches``;
* :func:`ssd_scan_kernel` — the dispatcher: a CPU tensor goes to the plain
  version, a CUDA tensor to the kernel (or an error).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

#: the CUDA kernel's chunk length (csrc kQ)
KERNEL_CHUNK = 64
#: (P, N) the CUDA kernel is compiled for, mamba2's head dim and state; a
#: smaller P or N is zero-padded up to it, a larger one refused
KERNEL_P, KERNEL_N = 64, 128


def pad_shape(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              init_state: Optional[torch.Tensor] = None):
    """x padded with zero columns to P = :data:`KERNEL_P`, b and c to
    N = :data:`KERNEL_N`, and ``init_state`` [B, H, P, N] with zeros to
    both (each unchanged where it already has the size).  Raises where P or
    N is larger."""
    P, N = x.shape[-1], b.shape[-1]
    if P > KERNEL_P or N > KERNEL_N:
        raise ValueError(f"ssd_scan_cuda: (P, N) = {(P, N)} above the compiled "
                         f"{(KERNEL_P, KERNEL_N)}")
    pad = torch.nn.functional.pad
    if P < KERNEL_P:
        x = pad(x, (0, KERNEL_P - P))
    if N < KERNEL_N:
        b, c = pad(b, (0, KERNEL_N - N)), pad(c, (0, KERNEL_N - N))
    if init_state is not None and (P, N) != (KERNEL_P, KERNEL_N):
        init_state = pad(init_state, (0, KERNEL_N - N, 0, KERNEL_P - P))
    return x, b, c, init_state


def segsum(dA: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise decay exponents: dA [..., Q] ->
    [..., Q, Q] with ``[i, j] = sum_{j < m <= i} dA_m`` for i >= j, -inf
    above the diagonal."""
    q = dA.shape[-1]
    cum = torch.cumsum(dA, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, float("-inf"))


# ---------------------------------------------------------------------------
# The plain version.
# ---------------------------------------------------------------------------


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, chunk: int,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``ssd_chunked`` in plain torch, operation for
    operation: matmul inputs in x's dtype (bfloat16 in the model), float32
    accumulation, chunk ``min(chunk, S)`` shrunk to a divisor of S."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    NC = S // Q
    cd = x.dtype

    def mm(t):  # round to the matmul dtype; products summed in float32
        return t.to(cd).float()

    dA = (dt * a).float()                                       # [B, S, H]
    xd = (x * dt[..., None]).to(cd)                             # dt-weighted

    xc = xd.reshape(B, NC, Q, H, P)
    dAc = dA.reshape(B, NC, Q, H)
    bc = b.reshape(B, NC, Q, N).to(cd)
    cc = c.reshape(B, NC, Q, N).to(cd)

    # --- intra-chunk (diagonal blocks): (C B^T ⊙ L) X
    L = torch.exp(segsum(dAc.permute(0, 1, 3, 2)))              # [B,NC,H,Q,Q]
    scores = torch.einsum("bcqn,bckn->bcqk", mm(cc), mm(bc))    # [B,NC,Q,Q]
    m = scores[:, :, None, :, :] * L                            # [B,NC,H,Q,Q]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", mm(m), mm(xc))

    # --- chunk states: sum_k exp(cum_last - cum_k) B_k xd_k^T
    cum = torch.cumsum(dAc, dim=2)                              # [B,NC,Q,H]
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)           # [B,NC,Q,H]
    states = torch.einsum("bckn,bckh,bckhp->bchpn", mm(bc),
                          mm(decay_states), mm(xc))             # [B,NC,H,P,N]

    # --- inter-chunk recurrence.
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # [B,NC,H]
    carry = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for ci in range(NC):  # emit the state *entering* each chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                      # [B,NC,H,P,N]

    # --- state -> output within each chunk.
    state_decay = torch.exp(cum)                                # [B,NC,Q,H]
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", mm(cc), mm(prev_states),
                         mm(state_decay))

    y = (y_diag + y_off).reshape(B, S, H, P)
    return y.to(x.dtype), carry


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------


def _library():
    """The built kernel library with its C signature declared."""
    lib = build.load("ssd_scan")
    if not getattr(lib, "_ssd_scan_typed", False):
        lib.ssd_scan_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_void_p]
        lib.ssd_scan_launch.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._ssd_scan_typed = True
    return lib


def _check(name: str, t: torch.Tensor, device: torch.device, dtype,
           dims: int, vector_rows: bool):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda takes CUDA tensors; {name} is on "
                         f"{getattr(t, 'device', type(t).__name__)}")
    if t.device != device:
        raise ValueError(f"ssd_scan_cuda: {name} is on {t.device}, x on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"ssd_scan_cuda takes {dtype} {name}, got {t.dtype}")
    if t.dim() != dims:
        raise ValueError(f"ssd_scan_cuda: {name} must be {dims}-D, got "
                         f"{tuple(t.shape)}")
    # x, b, c are read 8 bf16 (16 bytes) at a time along their last axis.
    if vector_rows and (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1])
                        or t.data_ptr() % 16):
        raise ValueError(f"ssd_scan_cuda: {name} needs a unit last stride, "
                         "other strides multiples of 8 elements and a 16-byte "
                         f"aligned base; got strides {t.stride()}")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ssd_scan.cu``: x ``[B, S, H, P]`` and b/c ``[B, S, N]``
    bfloat16 (any strides with a unit last stride: the model passes slices
    of the conv output), dt ``[B, S, H]`` and a ``[H]`` float32,
    ``init_state`` ``[B, H, P, N]`` float32 or None (zeros); P up to 64 and
    N up to 128 (smaller ones run zero-padded).  Returns ``(y [B, S, H, P]
    bf16, final_state [B, H, P, N] f32)``, still being computed on the
    current stream (slices of the padded outputs where P or N was padded).
    Builds the kernel with ``nvcc`` at first use.  Raises on any other
    input, and if the launch is refused."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("ssd_scan_cuda takes CUDA tensors; x is on "
                         f"{getattr(x, 'device', type(x).__name__)}")
    dev = x.device
    _check("x", x, dev, torch.bfloat16, 4, True)
    _check("b", b, dev, torch.bfloat16, 3, True)
    _check("c", c, dev, torch.bfloat16, 3, True)
    _check("dt", dt, dev, torch.float32, 3, False)
    _check("a", a, dev, torch.float32, 1, False)
    B, S, H, P = x.shape
    N = b.shape[-1]
    if (b.shape != (B, S, N) or c.shape != (B, S, N)
            or dt.shape != (B, S, H) or a.shape != (H,)):
        raise ValueError(
            f"ssd_scan_cuda: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)} do not "
            "form x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,N]")
    if init_state is not None:
        _check("init_state", init_state, dev, torch.float32, 4, False)
        if init_state.shape != (B, H, P, N):
            raise ValueError(f"ssd_scan_cuda: init_state {tuple(init_state.shape)}"
                             f" is not [B, H, P, N] = {(B, H, P, N)}")
    x, b, c, init_state = pad_shape(x, b, c, init_state)
    if init_state is not None:
        init_state = init_state.contiguous()
    y = torch.empty((B, S, H, KERNEL_P), dtype=torch.bfloat16, device=dev)
    final = torch.empty((B, H, KERNEL_P, KERNEL_N), dtype=torch.float32,
                        device=dev)
    if y.numel() == 0:
        final.copy_(init_state if init_state is not None else 0.0)
        return y[..., :P], final[:, :, :P, :N]
    a = a.contiguous()
    lib = _library()
    shape = (ctypes.c_int64 * 5)(B, S, H, KERNEL_P, KERNEL_N)
    strides = (ctypes.c_int64 * 13)(
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        b.stride(0), b.stride(1), c.stride(0), c.stride(1),
        y.stride(0), y.stride(1), y.stride(2))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(),
            init_state.data_ptr() if init_state is not None else None,
            y.data_ptr(), final.data_ptr(), shape, strides, stream)
    if rc != 0:
        raise RuntimeError("ssd_scan kernel launch failed: "
                           + lib.ssd_scan_error_string(rc).decode())
    ssd_scan_cuda.launches += 1
    if (P, N) != (KERNEL_P, KERNEL_N):
        return y[..., :P], final[:, :, :P, :N]
    return y, final


ssd_scan_cuda.launches = 0


def ssd_scan_kernel(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, chunk: int,
                    init_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, final_state)`` on x's device: a CPU tensor is computed by
    :func:`ssd_scan_plain` with ``chunk`` (autograd differentiates it), a
    CUDA tensor by the CUDA kernel with its own :data:`KERNEL_CHUNK` (the
    same function).  The kernel has no backward yet: on a CUDA tensor that
    needs a gradient this raises ``NotImplementedError``, and never falls
    back to the plain version."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk, init_state)
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, dt, a, b, c, init_state)):
            raise NotImplementedError(
                "ssd_scan has no backward kernel on the card yet (ROADMAP.md "
                "Queue 1, item 1: the ssd_scan backward kernel); the ssm "
                "family trains on the CPU (device='cpu') until then")
        return ssd_scan_cuda(x, dt, a, b, c, init_state)
    raise ValueError(f"no ssd_scan for device {x.device}")

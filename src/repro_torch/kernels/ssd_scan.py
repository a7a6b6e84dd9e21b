"""The Mamba2 SSD chunked scan as a CUDA kernel.

Prefill and training hot spot of the ssm family: ``models/ssm.py::
ssd_chunked`` calls :func:`ssd_scan_kernel` once per layer.  The
hand-written kernel in ``csrc/ssd_scan.cu`` replaces the JAX package's Pallas TPU kernel
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

The forward is computed by:

* :func:`ssd_scan_plain` — ``ssd_chunked`` in plain torch (any device);
* :func:`ssd_scan_cuda` — the CUDA kernel's wrapper, CUDA tensors only
  (x/b/c bfloat16, dt/a float32).  The kernel is compiled for
  (P, N) = (64, 128); the wrapper zero-pads a smaller P or N up to it
  (:func:`pad_shape`) and slices y and the final state back, which is
  exact: zero columns of x give zero rows of the state and of y, and zero
  columns of b and c add nothing to C Bᵀ or to C s.  With ``states=True``
  it also returns the float32 state entering each chunk of
  :data:`KERNEL_CHUNK` tokens (plain version :func:`ssd_chunk_states_plain`),
  which the backward reads.  It counts its launches in
  ``ssd_scan_cuda.launches``;
* :func:`ssd_scan_kernel` — the dispatcher: a CPU tensor goes to the plain
  version (autograd differentiates it), a CUDA or meta tensor to the
  kernel, through :class:`SSDScan` where it needs a gradient (or an
  error).

The gradient, with the final state's cotangent, which the JAX package takes
with ``jax.grad`` of ``ssd_chunked`` (it has no Pallas backward), by:

* :func:`ssd_scan_bwd_plain` — the backward of :func:`ssd_scan_plain`
  written out formula for formula (:func:`ssd_scan_bwd_terms` gives its
  float32 terms);
* :func:`ssd_scan_bwd_cuda` — the wrapper of ``csrc/ssd_scan_bwd.cu``
  (two kernels: the state cotangent chunk by chunk from the last, then
  every chunk's gradients), padded as the forward; launches counted in
  ``ssd_scan_bwd_cuda.launches``, one per call;
* :class:`SSDScan` — the ``torch.autograd.Function`` that runs the forward
  kernel with its chunk states and the backward kernel.

Both kernels are operators of torch's dispatcher,
``torch.ops.repro_torch.ssd_scan`` and ``ssd_scan_bwd`` (the launch, a
fake implementation, a FLOP formula from :func:`ssd_flops` /
:func:`ssd_bwd_flops`), which the ``_cuda`` wrappers call.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import OP_DEVICES, build, refuse_dtensor
from repro_torch.kernels.flash_attention import LIBRARY, _aligned

#: the CUDA kernel's chunk length (csrc kQ)
KERNEL_CHUNK = 64
#: (P, N) the CUDA kernel is compiled for, mamba2's head dim and state; a
#: smaller P or N is zero-padded up to it, a larger one refused
KERNEL_P, KERNEL_N = 64, 128


def n_chunks(S: int) -> int:
    """Chunks of :data:`KERNEL_CHUNK` tokens the kernels split S into (the
    last one ragged where S is not a multiple)."""
    return -(-S // KERNEL_CHUNK)


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


def pad_tokens(t: torch.Tensor) -> torch.Tensor:
    """``t`` [B, S, ...] zero-padded along S to ``n_chunks(S) *
    KERNEL_CHUNK`` tokens.  Tokens of dt = 0 carry the state unchanged, so
    x, dt, b, c (and dy) padded so give the scan's y, final state and
    gradients on the real tokens, chunked as the kernels chunk them."""
    pad = n_chunks(t.shape[1]) * KERNEL_CHUNK - t.shape[1]
    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


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


def _chunked(x, dt, a, b, c, chunk, init_state):
    """The forward's chunked terms, as :func:`ssd_scan_plain` computes
    them: (chunk Q, xd chunks [B,NC,Q,H,P] in x's dtype, b and c chunks
    [B,NC,Q,N] in x's dtype, cum [B,NC,Q,H], L [B,NC,H,Q,Q], the f32
    M = (C B^T) ⊙ L, the state entering each chunk [B,NC,H,P,N] and the
    final state, both f32)."""
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
    return Q, xc, bc, cc, cum, L, m, prev_states, carry


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, chunk: int,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``ssd_chunked`` in plain torch, operation for
    operation: matmul inputs in x's dtype (bfloat16 in the model), float32
    accumulation, chunk ``min(chunk, S)`` shrunk to a divisor of S."""
    B, S, H, P = x.shape
    cd = x.dtype

    def mm(t):
        return t.to(cd).float()

    _, xc, _, cc, cum, _, m, prev_states, carry = _chunked(
        x, dt, a, b, c, chunk, init_state)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", mm(m), mm(xc))

    # --- state -> output within each chunk.
    state_decay = torch.exp(cum)                                # [B,NC,Q,H]
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", mm(cc), mm(prev_states),
                         mm(state_decay))

    y = (y_diag + y_off).reshape(B, S, H, P)
    return y.to(x.dtype), carry


def ssd_chunk_states_plain(x: torch.Tensor, dt: torch.Tensor,
                           a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                           init_state: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The plain version of what ``ssd_scan_cuda(..., states=True)`` adds:
    the float32 state entering each chunk of :data:`KERNEL_CHUNK` tokens,
    ``[B, n_chunks(S), H, P, N]`` (a ragged S scanned as if padded with
    tokens of dt = 0, which carry the state unchanged)."""
    x, dt, b, c = (pad_tokens(t) for t in (x, dt, b, c))
    return _chunked(x, dt, a, b, c, KERNEL_CHUNK, init_state)[7]


def ssd_scan_bwd_terms(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, chunk: int,
                       init_state: Optional[torch.Tensor],
                       dy: torch.Tensor, dfinal: Optional[torch.Tensor]
                       ) -> dict:
    """The float32 terms :func:`ssd_scan_bwd_plain` assembles the gradient
    from: ``dxd`` [B, S, H, P] (the cotangent of dt x), ``ddA`` [B, S, H]
    (of dt a), ``dcum_off`` [B, S, H] (the off-chunk term exp(cum) dy ·
    (s C) of d cum, whose reverse cumsum within each chunk is its part of
    ``ddA``), ``db``, ``dc`` [B, S, N] and ``dinit``
    (None without ``init_state``).  ``chip_smoke.py`` renders faults of
    the backward from them."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    cd = x.dtype

    def mm(t):
        return t.to(cd).float()

    def suffix_sum(t):  # over the chunk's tokens, from each one to the end
        return torch.flip(torch.cumsum(torch.flip(t, (2,)), dim=2), (2,))

    Q, xc, bc, cc, cum, L, m, prev, _ = _chunked(
        x, dt, a, b, c, chunk, init_state)
    NC = S // Q
    xc, bc, cc = xc.float(), bc.float(), cc.float()
    dyc = dy.float().reshape(B, NC, Q, H, P)
    e = torch.exp(cum)                                          # [B,NC,Q,H]
    w = torch.exp(cum[:, :, -1:, :] - cum)                      # [B,NC,Q,H]
    decay = torch.exp(cum[:, :, -1, :])                         # [B,NC,H]

    # The state cotangent, chunk by chunk from the last: G[:, ci] is that of
    # the state leaving chunk ci.
    dyw = mm(e[..., None] * dyc)                                # [B,NC,Q,H,P]
    inflow = torch.einsum("bcqhp,bcqn->bchpn", dyw, cc)         # [B,NC,H,P,N]
    g = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if dfinal is None else dfinal.float())
    gs = [None] * NC
    for ci in reversed(range(NC)):
        gs[ci] = g
        g = g * decay[:, ci, :, None, None] + inflow[:, ci]
    G = torch.stack(gs, dim=1)                                  # [B,NC,H,P,N]
    Gr, sr = mm(G), mm(prev)

    # Inside each chunk.
    dM = torch.einsum("bcqhp,bckhp->bchqk", mm(dyc), xc)        # [B,NC,H,Q,Q]
    dS = mm((dM * L).sum(dim=2))                                # [B,NC,Q,Q]
    T = dM * m
    dcum = (T.sum(dim=-1) - T.sum(dim=-2)).permute(0, 1, 3, 2)  # [B,NC,Q,H]
    U = torch.einsum("bckn,bchpn->bckhp", bc, Gr)               # [B,NC,Q,H,P]
    dxd = (torch.einsum("bchqk,bcqhp->bckhp", mm(m), mm(dyc))
           + w[..., None] * U)
    dw = (xc * U).sum(dim=-1)                                   # [B,NC,Q,H]
    V = torch.einsum("bcqn,bchpn->bcqhp", cc, sr)
    off = e * (dyc * V).sum(dim=-1)
    dcum = dcum + off - w * dw
    last = ((w * dw).sum(dim=2)
            + decay * (G * prev).sum(dim=(-2, -1)))             # [B,NC,H]
    dcum[:, :, -1] += last

    dc = (torch.einsum("bcqk,bckn->bcqn", dS, bc)
          + torch.einsum("bcqhp,bchpn->bcqn", dyw, sr))
    db = (torch.einsum("bcqk,bcqn->bckn", dS, cc)
          + (w[..., None] * torch.einsum("bckhp,bchpn->bckhn", xc, Gr))
          .sum(dim=3))
    return {"dxd": dxd.reshape(B, S, H, P),
            "ddA": suffix_sum(dcum).reshape(B, S, H),
            "dcum_off": off.reshape(B, S, H),
            "db": db.reshape(B, S, N), "dc": dc.reshape(B, S, N),
            "dinit": None if init_state is None else g}


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, chunk: int,
                       init_state: Optional[torch.Tensor],
                       dy: torch.Tensor, dfinal: Optional[torch.Tensor]):
    """The gradient of :func:`ssd_scan_plain` written out formula for
    formula (no autograd): the cotangents ``dy`` of y and ``dfinal`` of the
    final state (None: zero) give ``(dx, ddt, da, db, dc, dinit)``, dx, db
    and dc in x's dtype, ddt, da and dinit float32 (dinit None where
    ``init_state`` is None).  It is the arithmetic of ``csrc/ssd_scan_bwd
    .cu``: every product takes its inputs rounded to x's dtype and sums in
    float32, everything else is float32.

    Per chunk, with cum the inclusive cumsum of dt a, L[i, j] =
    exp(cum_i - cum_j) (i >= j), M = (C B^T) ⊙ L, w_j = exp(cum_last -
    cum_j), s the state entering the chunk and G the cotangent of the state
    leaving it::

        G_prev = exp(cum_last) G + (exp(cum) ⊙ dy)^T C    (G_last = dfinal)
        dM     = dy xd^T,  dS = sum_h dM ⊙ L,  T = dM ⊙ M
        dxd    = M^T dy + w ⊙ (B G^T),  dw_j = xd_j · (G B_j)
        dC     = dS B + sum_h (exp(cum) ⊙ dy) s,  dB = dS^T C + sum_h w ⊙ (xd G)
        dcum_i = sum_j T_ij - sum_j T_ji + exp(cum_i) dy_i · (s C_i)
                 - w_i dw_i,  dcum_last += sum_j w_j dw_j
                 + exp(cum_last) <G, s>
        d(dA)  = the reverse cumsum of dcum within the chunk
        ddt    = d(dA) a + sum_p dxd x,  dx = dxd dt,  da = sum d(dA) dt
    """
    cd = x.dtype
    t = ssd_scan_bwd_terms(x, dt, a, b, c, chunk, init_state, dy, dfinal)
    ddA, dxd = t["ddA"], t["dxd"]
    ddt = ddA * a.float() + (dxd * x.float()).sum(dim=-1)
    dx = dxd * dt.float()[..., None]
    da = (ddA * dt.float()).sum(dim=(0, 1))
    return (dx.to(cd), ddt, da, t["db"].to(cd), t["dc"].to(cd), t["dinit"])


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------


def _library():
    """The built forward kernel library with its C signature declared."""
    lib = build.load("ssd_scan")
    if not getattr(lib, "_ssd_scan_typed", False):
        lib.ssd_scan_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
        lib.ssd_scan_launch.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._ssd_scan_typed = True
    return lib


def _bwd_library():
    """The built backward kernel library with its C signature declared."""
    lib = build.load("ssd_scan_bwd")
    if not getattr(lib, "_ssd_scan_bwd_typed", False):
        lib.ssd_scan_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.POINTER(ctypes.c_int64)] * 2
            + [ctypes.c_void_p])
        lib.ssd_scan_bwd_launch.restype = ctypes.c_int
        lib.ssd_scan_bwd_launch_parts.argtypes = (
            lib.ssd_scan_bwd_launch.argtypes + [ctypes.c_int])
        lib.ssd_scan_bwd_launch_parts.restype = ctypes.c_int
        lib.ssd_scan_bwd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p
        lib._ssd_scan_bwd_typed = True
    return lib


def _check(fn: str, name: str, t: torch.Tensor, device: torch.device,
           dtype, dims: int, vector_rows: bool):
    """Device, dtype, rank and, for a tensor read in 16-byte vectors along
    its last axis, strides; the base address is the launch's to check
    (:func:`_check_aligned`), as a fake tensor has none."""
    if not isinstance(t, torch.Tensor) or t.device.type not in OP_DEVICES:
        raise ValueError(f"{fn} takes CUDA tensors; {name} is on "
                         f"{getattr(t, 'device', type(t).__name__)}")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn} takes {dtype} {name}, got {t.dtype}")
    if t.dim() != dims:
        raise ValueError(f"{fn}: {name} must be {dims}-D, got "
                         f"{tuple(t.shape)}")
    # x, b, c and dy are read 8 bf16 (16 bytes) at a time along their last
    # axis.
    if vector_rows and (t.stride(-1) != 1
                        or any(s % 8 for s in t.stride()[:-1])):
        raise ValueError(f"{fn}: {name} needs a unit last stride, other "
                         "strides multiples of 8 elements and a 16-byte "
                         f"aligned base; got strides {t.stride()}")


def _check_aligned(fn: str, name: str, t: torch.Tensor, align: int = 16):
    """Raise unless ``t``'s first element sits at a multiple of ``align``
    bytes: x, b, c and dy are read in 16-byte vectors, the backward moves
    the chunk states by bulk copies of 512-byte rows and reads dfinal in
    8-byte pairs, and none takes a view that starts elsewhere (nothing is
    copied to fix it)."""
    if t.data_ptr() % align:
        raise ValueError(f"{fn}: {name} must start at a {align}-byte "
                         f"aligned address, got {t.data_ptr():#x} (a view "
                         "into another tensor?)")


def _check_operands(fn: str, x, dt, a, b, c, init_state):
    """The checks both wrappers make of the forward's operands; returns
    (B, S, H, P, N)."""
    if not isinstance(x, torch.Tensor) or x.device.type not in OP_DEVICES:
        raise ValueError(f"{fn} takes CUDA tensors; x is on "
                         f"{getattr(x, 'device', type(x).__name__)}")
    dev = x.device
    _check(fn, "x", x, dev, torch.bfloat16, 4, True)
    _check(fn, "b", b, dev, torch.bfloat16, 3, True)
    _check(fn, "c", c, dev, torch.bfloat16, 3, True)
    _check(fn, "dt", dt, dev, torch.float32, 3, False)
    _check(fn, "a", a, dev, torch.float32, 1, False)
    B, S, H, P = x.shape
    N = b.shape[-1]
    if (b.shape != (B, S, N) or c.shape != (B, S, N)
            or dt.shape != (B, S, H) or a.shape != (H,)):
        raise ValueError(
            f"{fn}: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)} do not "
            "form x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,N]")
    if init_state is not None:
        _check(fn, "init_state", init_state, dev, torch.float32, 4, False)
        if init_state.shape != (B, H, P, N):
            raise ValueError(f"{fn}: init_state {tuple(init_state.shape)}"
                             f" is not [B, H, P, N] = {(B, H, P, N)}")
    return B, S, H, P, N


def _check_bwd(fn: str, x, dt, a, b, c, states, dy, dfinal):
    """:func:`_check_operands` and the backward's own operands; returns
    (B, S, H, P, N)."""
    B, S, H, P, N = _check_operands(fn, x, dt, a, b, c, None)
    dev = x.device
    _check(fn, "dy", dy, dev, torch.bfloat16, 4, True)
    if dy.shape != x.shape:
        raise ValueError(f"{fn}: dy {tuple(dy.shape)} must be shaped as x "
                         f"{tuple(x.shape)}")
    want = (B, n_chunks(S), H, KERNEL_P, KERNEL_N)
    if (not isinstance(states, torch.Tensor) or states.device != dev
            or states.dtype != torch.float32 or states.shape != want
            or not states.is_contiguous()):
        raise ValueError(f"{fn}: states must be the forward's contiguous "
                         f"float32 {want} chunk states on {dev}")
    if dfinal is not None:
        _check(fn, "dfinal", dfinal, dev, torch.float32, 4, False)
        if dfinal.shape != (B, H, P, N):
            raise ValueError(f"{fn}: dfinal {tuple(dfinal.shape)} is not "
                             f"[B, H, P, N] = {(B, H, P, N)}")
    return B, S, H, P, N


# ---------------------------------------------------------------------------
# The kernels as operators of torch's dispatcher: a CUDA implementation (the
# launch), a fake one (the outputs' sizes, dtypes and strides from the same
# allocation code) and a FLOP formula each, as in ``flash_attention.py``.
# ---------------------------------------------------------------------------

LIBRARY.define("ssd_scan(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c, "
               "Tensor? init_state, bool states) -> (Tensor, Tensor, Tensor)")
LIBRARY.define("ssd_scan_bwd(Tensor x, Tensor dt, Tensor a, Tensor b, "
               "Tensor c, Tensor states, Tensor dy, Tensor? dfinal, "
               "bool round_g) -> (Tensor, Tensor, Tensor, Tensor, Tensor, "
               "Tensor)")


def ssd_flops(B: int, S: int, H: int, P: int, N: int,
              q: int = KERNEL_CHUNK) -> int:
    """FLOPs of the SSD scan's chunked products at chunk q: intra-chunk on
    and below the diagonal, C B^T once per chunk for all heads, the state
    term C s and the state update (2 per multiply-add)."""
    nc = -(-S // q)
    tri = q * (q + 1) // 2
    return (B * nc * 2 * tri * N                          # C B^T, shared
            + B * H * nc * (2 * tri * P + 4 * q * N * P))  # M x, C s, update


def ssd_bwd_flops(B: int, S: int, H: int, P: int, N: int,
                  q: int = KERNEL_CHUNK) -> int:
    """FLOPs of the SSD backward's products at chunk q: the forward's C B^T
    and, per chunk, dS B and dS^T C once for all heads; per chunk and head
    dM = dy xd^T and M^T dy on and below the diagonal, and the state
    cotangent, B G^T, C s^T and the state terms of dC and dB."""
    nc = -(-S // q)
    tri = q * (q + 1) // 2
    return (B * nc * 2 * tri * N * 3            # C B^T, dS B, dS^T C
            + B * H * nc * (2 * tri * P * 2      # dM, M^T dy
                            + 2 * q * P * N * 5))  # G, B G^T, C s^T, dC, dB


def _fwd_outputs(B: int, S: int, H: int, P: int, N: int, states: bool,
                 device):
    """The forward's buffers as the launch allocates them, at the compiled
    (P, N): y [B, S, H, KERNEL_P] bf16, the final state [B, H, KERNEL_P,
    KERNEL_N] f32 and the chunk states [B, n_chunks(S), H, KERNEL_P,
    KERNEL_N] f32 (empty without ``states``); and the outputs: y and the
    final state sliced to (P, N) where they were padded, the chunk states
    as they are."""
    y = torch.empty((B, S, H, KERNEL_P), dtype=torch.bfloat16, device=device)
    final = torch.empty((B, H, KERNEL_P, KERNEL_N), dtype=torch.float32,
                        device=device)
    chunk_states = torch.empty(
        (B, n_chunks(S), H, KERNEL_P, KERNEL_N) if states else (0,),
        dtype=torch.float32, device=device)
    if (P, N) != (KERNEL_P, KERNEL_N):
        return (y, final), (y[..., :P], final[:, :, :P, :N], chunk_states)
    return (y, final), (y, final, chunk_states)


def _ssd_scan_launch(x, dt, a, b, c, init_state, states):
    """``repro_torch::ssd_scan`` on the card: the launch, on operands
    :func:`ssd_scan_cuda` has checked."""
    fn = "ssd_scan_cuda"
    B, S, H, P = x.shape
    N = b.shape[-1]
    for name, t in (("x", x), ("b", b), ("c", c)):
        _check_aligned(fn, name, t)
    dev = x.device
    x, b, c, init_state = pad_shape(x, b, c, init_state)
    if init_state is not None:
        init_state = init_state.contiguous()
    (y, final), out = _fwd_outputs(B, S, H, P, N, states, dev)
    if y.numel() == 0:
        final.copy_(init_state if init_state is not None else 0.0)
        return out
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
            y.data_ptr(), final.data_ptr(),
            out[2].data_ptr() if states else None, shape, strides,
            stream)
    if rc != 0:
        raise RuntimeError("ssd_scan kernel launch failed: "
                           + lib.ssd_scan_error_string(rc).decode())
    ssd_scan_cuda.launches += 1
    return out


def _ssd_scan_fake(x, dt, a, b, c, init_state, states):
    B, S, H, P, N = _check_operands("ssd_scan_cuda", x, dt, a, b, c,
                                    init_state)
    return _fwd_outputs(B, S, H, P, N, states, x.device)[1]


def _bwd_outputs(B: int, S: int, H: int, P: int, N: int, device):
    """The backward's buffers as the launch allocates them, at the compiled
    (P, N): dx, ddt, da's per-(batch, chunk) partials, db, dc and dinit."""
    f32 = dict(dtype=torch.float32, device=device)
    dx = torch.empty((B, S, H, KERNEL_P), dtype=torch.bfloat16, device=device)
    ddt = torch.empty((B, S, H), **f32)
    da_part = torch.empty((B, n_chunks(S), H), **f32)
    db, dc = (torch.empty((B, S, KERNEL_N), dtype=torch.bfloat16,
                          device=device) for _ in range(2))
    dinit = torch.empty((B, H, KERNEL_P, KERNEL_N), **f32)
    return dx, ddt, da_part, db, dc, dinit


def _bwd_result(P: int, N: int, dx, ddt, da_part, db, dc, dinit):
    """(dx, ddt, da, db, dc, dinit) from the buffers: da summed over batch
    and chunks, the rest sliced to (P, N) where they were padded."""
    da = da_part.sum(dim=(0, 1))
    if (P, N) != (KERNEL_P, KERNEL_N):
        return (dx[..., :P], ddt, da, db[..., :N], dc[..., :N],
                dinit[:, :, :P, :N])
    return dx, ddt, da, db, dc, dinit


def _ssd_scan_bwd_launch(x, dt, a, b, c, states, dy, dfinal, round_g):
    """``repro_torch::ssd_scan_bwd`` on the card: the two launches, on
    operands :func:`ssd_scan_bwd_cuda` has checked."""
    fn = "ssd_scan_bwd_cuda"
    B, S, H, P = x.shape
    N = b.shape[-1]
    for name, t in (("x", x), ("b", b), ("c", c), ("dy", dy),
                    ("states", states)):
        _check_aligned(fn, name, t)
    dev = x.device
    x, b, c, dfinal = pad_shape(x, b, c, dfinal)
    if P < KERNEL_P:
        dy = torch.nn.functional.pad(dy, (0, KERNEL_P - P))
    if dfinal is not None:
        dfinal = dfinal.contiguous()
        _check_aligned(fn, "dfinal", dfinal)
    bufs = _bwd_outputs(B, S, H, P, N, dev)
    dx, ddt, da_part, db, dc, dinit = bufs
    if dx.numel() == 0:
        for t in (dx, ddt, da_part, db, dc):
            t.zero_()
        dinit.copy_(dfinal if dfinal is not None else 0.0)
        return _bwd_result(P, N, *bufs)
    # the state cotangents, kernel 1 -> 2
    ds = torch.empty(states.shape, dtype=torch.float32, device=dev)
    a = a.contiguous()
    lib = _bwd_library()
    shape = (ctypes.c_int64 * 5)(B, S, H, KERNEL_P, KERNEL_N)
    strides = (ctypes.c_int64 * 13)(
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        b.stride(0), b.stride(1), c.stride(0), c.stride(1),
        dy.stride(0), dy.stride(1), dy.stride(2))
    args = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), states.data_ptr(), dy.data_ptr(),
            dfinal.data_ptr() if dfinal is not None else None,
            ds.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            da_part.data_ptr(), db.data_ptr(), dc.data_ptr(),
            dinit.data_ptr(), shape, strides)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if round_g:
            rc = lib.ssd_scan_bwd_launch_parts(*args, stream, 1)
            ds.copy_(ds.bfloat16())
            rc = rc or lib.ssd_scan_bwd_launch_parts(*args, stream, 2)
        else:
            rc = lib.ssd_scan_bwd_launch(*args, stream)
    if rc != 0:
        raise RuntimeError("ssd_scan backward kernel launch failed: "
                           + lib.ssd_scan_bwd_error_string(rc).decode())
    ssd_scan_bwd_cuda.launches += 1
    return _bwd_result(P, N, *bufs)


def _ssd_scan_bwd_fake(x, dt, a, b, c, states, dy, dfinal, round_g):
    B, S, H, P, N = _check_bwd("ssd_scan_bwd_cuda", x, dt, a, b, c, states,
                               dy, dfinal)
    return _bwd_result(P, N, *_bwd_outputs(B, S, H, P, N, x.device))


LIBRARY.impl("ssd_scan", _ssd_scan_launch, "CUDA")
LIBRARY.impl("ssd_scan_bwd", _ssd_scan_bwd_launch, "CUDA")
torch.library.register_fake("repro_torch::ssd_scan", _ssd_scan_fake,
                            lib=LIBRARY)
torch.library.register_fake("repro_torch::ssd_scan_bwd", _ssd_scan_bwd_fake,
                            lib=LIBRARY)


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _ssd_scan_flop(x, dt, a, b, c, init_state, states, *args,
                   **kwargs) -> int:
    """FLOPs of one forward launch: :func:`ssd_flops` at the compiled (P,
    N) and chunk (what the kernel computes)."""
    B, S, H, _ = x
    return ssd_flops(B, S, H, KERNEL_P, KERNEL_N)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _ssd_scan_bwd_flop(x, dt, a, b, c, states, dy, dfinal, round_g, *args,
                       **kwargs) -> int:
    """FLOPs of one backward call: :func:`ssd_bwd_flops` at the compiled
    (P, N) and chunk."""
    B, S, H, _ = x
    return ssd_bwd_flops(B, S, H, KERNEL_P, KERNEL_N)


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None, *,
                  states: bool = False):
    """Launch ``csrc/ssd_scan.cu`` (the op ``repro_torch::ssd_scan``): x
    ``[B, S, H, P]`` and b/c ``[B, S, N]``
    bfloat16 (any strides with a unit last stride: the model passes slices
    of the conv output), dt ``[B, S, H]`` and a ``[H]`` float32,
    ``init_state`` ``[B, H, P, N]`` float32 or None (zeros); P up to 64 and
    N up to 128 (smaller ones run zero-padded).  Returns ``(y [B, S, H, P]
    bf16, final_state [B, H, P, N] f32)``, still being computed on the
    current stream (slices of the padded outputs where P or N was padded).
    With ``states`` the kernel's other instantiation also writes the
    float32 state entering each chunk of :data:`KERNEL_CHUNK` tokens, which
    the backward reads, and the result gains it as a third entry: ``[B,
    n_chunks(S), H, KERNEL_P, KERNEL_N]``, in the padded shape the backward
    takes.  Builds the kernel with ``nvcc`` at first use.  Raises on any
    other input, and if the launch is refused.  A fake or meta tensor runs
    the op's fake implementation: shapes only, nothing launched."""
    _check_operands("ssd_scan_cuda", x, dt, a, b, c, init_state)
    y, final, chunk_states = torch.ops.repro_torch.ssd_scan.default(
        x, dt, a, b, c, init_state, bool(states))
    return (y, final, chunk_states) if states else (y, final)


ssd_scan_cuda.launches = 0


def ssd_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, states: torch.Tensor,
                      dy: torch.Tensor, dfinal: Optional[torch.Tensor] = None,
                      *, round_g: bool = False):
    """Launch ``csrc/ssd_scan_bwd.cu`` (the op ``repro_torch::ssd_scan_bwd``:
    its two kernels, the state
    cotangent chunk by chunk from the last, then every chunk's gradients):
    x, dt, a, b, c as :func:`ssd_scan_cuda` takes them, ``states`` the
    chunk states ``ssd_scan_cuda(..., states=True)`` wrote for them, dy
    ``[B, S, H, P]`` bfloat16 under the same stride rules as x, ``dfinal``
    ``[B, H, P, N]`` float32 or None (zero).  Returns ``(dx, ddt, da, db,
    dc, dinit)`` as :func:`ssd_scan_bwd_plain` does, dinit always, still
    being computed on the current stream.  Zero-pads P and N as the
    forward does (dy and dfinal too) and slices the gradients back.  ``da``
    is a ``torch.sum`` over batch and chunks of the kernel's per-chunk
    partial sums, a fixed order.  Counts one launch per call in
    ``ssd_scan_bwd_cuda.launches``.  ``states`` (and ``dfinal``) must
    start 16-byte aligned (:func:`_check_aligned`).  Raises on any other
    input and if a launch is refused.

    ``round_g`` is a probe that the training path never sets: the state
    cotangents the first kernel hands the second are rounded to bf16 in
    between (the two kernels launched apart), which is what storing them in
    bf16 would cost in accuracy."""
    _check_bwd("ssd_scan_bwd_cuda", x, dt, a, b, c, states, dy, dfinal)
    return torch.ops.repro_torch.ssd_scan_bwd.default(
        x, dt, a, b, c, states, dy, dfinal, bool(round_g))


ssd_scan_bwd_cuda.launches = 0


class SSDScan(torch.autograd.Function):
    """The SSD scan on the card with a gradient: the forward kernel, which
    also writes the state entering each chunk, and the backward kernel.
    The gradient is the JAX package's ``jax.grad`` of the same function
    (``ssd_chunked``), the final state's cotangent included, computed by
    hand-written kernels.  Gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, init_state):
        y, final, states = ssd_scan_cuda(x, dt, a, b, c, init_state,
                                         states=True)
        ctx.save_for_backward(x, dt, a, b, c, states)
        ctx.has_init = init_state is not None
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, b, c, states = ctx.saved_tensors
        dy = (torch.zeros(x.shape, dtype=x.dtype, device=x.device)
              if dy is None else _aligned(dy))
        dx, ddt, da, db, dc, dinit = ssd_scan_bwd_cuda(
            x, dt, a, b, c, states, dy, dfinal)
        return dx, ddt, da, db, dc, dinit if ctx.has_init else None


def ssd_scan_kernel(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, chunk: int,
                    init_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, final_state)`` on x's device: a CPU tensor is computed by
    :func:`ssd_scan_plain` with ``chunk`` (autograd differentiates it), a
    CUDA tensor by the CUDA kernel with its own :data:`KERNEL_CHUNK` (the
    same function): through :class:`SSDScan` and its backward kernel where
    grad is enabled and an input requires it, else the forward alone.  A
    meta tensor takes the kernel's custom ops as a CUDA tensor does, which
    run their fake implementations.  A DTensor input raises."""
    refuse_dtensor("ssd_scan_kernel", x, dt, a, b, c, init_state)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk, init_state)
    if x.device.type in OP_DEVICES:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, dt, a, b, c, init_state)):
            return SSDScan.apply(x, dt, a, b, c, init_state)
        return ssd_scan_cuda(x, dt, a, b, c, init_state)
    raise ValueError(f"no ssd_scan for device {x.device}")

"""Forward GQA attention (causal and/or sliding window, with an optional
bidirectional prefix) as a CUDA kernel.

Prefill hot spot of every attention family: ``models/attention.py::
blockwise_attention`` calls :func:`flash_attention_kernel` once per
attention layer (self-attention, whisper's encoder and cross-attention).
The hand-written kernel in ``csrc/flash_attention.cu`` replaces the JAX
package's Pallas TPU kernel ``repro/kernels/flash_attention.py::_kernel``,
launched there by ``flash_attention``.

Layout: the model's, q ``[B, Sq, H, dh]`` and k/v ``[B, Sk, KV, dh]`` with
``H = KV * g`` (query head ``h`` reads kv head ``h // g``).  The kernel
takes strides, so the public ``ops.flash_attention`` passes transposed
views of the JAX layout ``[B, H, S, dh]`` without a copy.

The function, on every path: scores ``q kᵀ`` with float32 accumulation,
times the real ``dh ** -0.5``; masked entries (above the diagonal, outside
the window, keys past ``Sk``) set to ``NEG_INF = -1e30``, except that a key
below ``bidirectional_prefix`` is visible to every query (the vlm family's
image tokens attend to each other both ways); a running max and
sum in float32 across key blocks; ``p`` rounded to the matmul dtype before
``p v``; the output divided by ``max(l, 1e-30)``, in the input dtype.

Three functions compute it:

* :func:`flash_attention_plain` — the reference's ``blockwise_attention``
  in plain torch (any device, any float dtype: the matmul inputs are
  rounded to the dtype of ``q``, bfloat16 on the model path as the
  reference casts them, float32 where a caller passes float32 as the
  Pallas body computes);
* :func:`flash_attention_cuda` — the CUDA kernel's wrapper, bfloat16 CUDA
  tensors only; the kernel is compiled for :data:`HEAD_DIMS`, and the
  wrapper zero-pads any other dh up to 256 to the next of them
  (:func:`kernel_head_dim`, :func:`pad_head_dim`): zero columns of q and k
  add nothing to a score, zero columns of v give zero output columns,
  which it slices away, and it passes the scale of the real dh.  It counts
  its launches in ``flash_attention_cuda.launches``;
* :func:`flash_attention_kernel` — the dispatcher: a CPU tensor goes to the
  plain version, a CUDA tensor to the kernel (or an error).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
DEFAULT_CHUNK = 1024
#: head dims the CUDA kernel is compiled for; any other dh up to 256 is
#: zero-padded to the next of them by the wrapper
HEAD_DIMS = (64, 80, 128, 256)


def kernel_head_dim(dh: int) -> int:
    """The compiled head dim that ``dh`` runs at: the least of
    :data:`HEAD_DIMS` not below it.  Raises above 256."""
    for d in HEAD_DIMS:
        if dh <= d:
            return d
    raise ValueError(f"flash_attention_cuda: head dim {dh} above the largest "
                     f"compiled one, {HEAD_DIMS[-1]}")


def pad_head_dim(t: torch.Tensor, dh: int) -> torch.Tensor:
    """``t`` [..., d] with zero columns appended up to ``dh`` (``t`` itself
    when ``d == dh``)."""
    extra = dh - t.shape[-1]
    return torch.nn.functional.pad(t, (0, extra)) if extra else t


def pick_chunk(s: int, chunk: int) -> Tuple[int, int]:
    """Pick a block size and (possibly padded) length for ``s``.

    Prefers the largest divisor of ``s`` in (chunk/2, chunk]; if none
    exists, keeps ``chunk`` and pads ``s`` up to a multiple (padded keys are
    masked, padded queries sliced away)."""
    if s <= chunk:
        return s, s
    for c in range(chunk, chunk // 2, -1):
        if s % c == 0:
            return c, s
    return chunk, -(-s // chunk) * chunk


# ---------------------------------------------------------------------------
# The plain version.
# ---------------------------------------------------------------------------


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, window: Optional[int] = None,
                          chunk: int = DEFAULT_CHUNK,
                          bidirectional_prefix: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Block attention with static block skipping (the reference's
    ``blockwise_attention``, ``models/attention.py:96-178``).

    q: [B, Sq, H, dh]; k/v: [B, Sk, KV, dh].  Both are split into chunks;
    for each q chunk only the causally / window-wise reachable kv chunks
    are computed, combined by running-max softmax rescaling.  Positions
    below ``bidirectional_prefix`` attend to each other both ways (and,
    under a window, stay visible to every query); as in the reference the
    prefix must fit the first chunk.  ``scale`` defaults to ``dh ** -0.5``.
    Returns [B, Sq, H, dh] in q's dtype."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    cd = q.dtype
    cq, sq_pad = pick_chunk(Sq, chunk)
    ck, sk_pad = pick_chunk(Sk, chunk)
    if sq_pad != Sq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sq_pad - Sq))
    if sk_pad != Sk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, sk_pad - Sk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, sk_pad - Sk))
    kv_limit = Sk if sk_pad != Sk else None   # mask padded keys
    nq, nk = sq_pad // cq, sk_pad // ck
    prefix = bidirectional_prefix
    if not (prefix <= cq or nq == 1):
        raise ValueError(f"bidirectional prefix {prefix} must fit one chunk "
                         f"({cq})")
    if scale is None:
        scale = dh ** -0.5
    dev = q.device
    # Matmul inputs rounded to cd, products summed in float32.
    qg = q.reshape(B, nq, cq, KV, g, dh).to(cd).float()
    kc = k.reshape(B, nk, ck, KV, dh).to(cd).float()
    vc = v.reshape(B, nk, ck, KV, dh).to(cd).float()

    out_chunks = []
    for qi in range(nq):
        q_lo, q_hi = qi * cq, (qi + 1) * cq
        q_pos = torch.arange(q_lo, q_hi, device=dev)
        m = torch.full((B, KV, g, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, g, cq), dtype=torch.float32, device=dev)
        o = torch.zeros((B, KV, g, cq, dh), dtype=torch.float32, device=dev)
        for kj in range(nk):
            k_lo, k_hi = kj * ck, (kj + 1) * ck
            if causal and k_lo > q_hi - 1:
                continue  # strictly-upper block: skipped
            if (window is not None and k_hi - 1 < q_lo - window + 1
                    and not (prefix and k_lo < prefix)):
                continue  # outside the sliding window: skipped
            k_pos = torch.arange(k_lo, k_hi, device=dev)
            s = torch.einsum("bqkgd,bckd->bkgqc", qg[:, qi], kc[:, kj]) * scale
            mask = None
            if causal and k_hi > q_lo:  # diagonal-crossing block
                mask = q_pos[:, None] >= k_pos[None, :]
                if prefix:
                    mask = mask | ((q_pos[:, None] < prefix)
                                   & (k_pos[None, :] < prefix))
            if window is not None and k_lo <= q_hi - window:
                wmask = q_pos[:, None] - k_pos[None, :] < window
                if prefix:
                    wmask = wmask | (k_pos[None, :] < prefix)
                mask = wmask if mask is None else (mask & wmask)
            if kv_limit is not None and k_hi > kv_limit:
                vmask = (k_pos[None, :] < kv_limit).expand(cq, ck)
                mask = vmask if mask is None else (mask & vmask)
            if mask is not None:
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(cd).float(), vc[:, kj])
            o = o * corr[..., None] + pv
            m = m_new
        out_chunks.append(o / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(out_chunks, dim=1)  # [B, nq, KV, g, cq, dh]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, sq_pad, H, dh)
    return out[:, :Sq].to(cd)


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------


def _library():
    """The built kernel library with its C signature declared."""
    lib = build.load("flash_attention")
    if not getattr(lib, "_flash_attention_typed", False):
        lib.flash_attention_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._flash_attention_typed = True
    return lib


def _check_operand(name: str, t: torch.Tensor, device: torch.device):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda takes CUDA tensors; {name} is "
                         f"on {getattr(t, 'device', type(t).__name__)}")
    if t.device != device:
        raise ValueError(f"flash_attention_cuda: {name} is on {t.device}, "
                         f"q on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_cuda takes bfloat16; {name} is "
                        f"{t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"flash_attention_cuda: {name} must be 4-D "
                         f"[B, S, heads, dh], got {tuple(t.shape)}")
    # 16-byte loads of 8 bf16 along dh: unit dh stride, other strides whole
    # 16-byte steps, 16-byte aligned base.
    if (t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3])
            or t.data_ptr() % 16):
        raise ValueError(f"flash_attention_cuda: {name} needs a unit head-dim "
                         "stride, other strides multiples of 8 elements and a "
                         f"16-byte aligned base; got strides {t.stride()}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int] = None,
                         prefix: int = 0) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on bfloat16 CUDA tensors q
    ``[B, Sq, H, dh]``, k/v ``[B, Sk, KV, dh]`` (any strides with a unit
    head-dim stride), keys below ``prefix`` visible to every query.  Returns
    the output with q's shape (q's strides where dh is compiled, else a
    slice of the padded output), still being computed on the current
    stream.  Builds the kernel with ``nvcc`` at first use.  Raises on any
    other input, a dh above 256 included, and if the launch is refused."""
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError("flash_attention_cuda takes CUDA tensors; q is on "
                         f"{getattr(q, 'device', type(q).__name__)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"flash_attention_cuda: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be [B, Sk, KV, dh] with q "
                         f"{tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention_cuda: {H} query heads over {KV} "
                         "kv heads")
    dk = kernel_head_dim(dh)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_cuda: window {window} < 1")
    if prefix < 0:
        raise ValueError(f"flash_attention_cuda: prefix {prefix} < 0")
    scale = float(dh ** -0.5)     # the real dh's, whatever the padding
    q, k, v = (pad_head_dim(t, dk) for t in (q, k, v))
    out = torch.empty_like(q)   # q's strides where q is dense
    if out.numel() == 0:
        return out[..., :dh]
    lib = _library()
    shape = (ctypes.c_int64 * 6)(B, H, KV, Sq, Sk, dk)
    strides = (ctypes.c_int64 * 12)(
        *(s for t in (q, k, v, out) for s in (t.stride(0), t.stride(1),
                                              t.stride(2))))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), shape,
            strides, int(bool(causal)), int(window or 0), int(prefix), scale,
            stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    flash_attention_cuda.launches += 1
    return out[..., :dh] if dk != dh else out


flash_attention_cuda.launches = 0


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool, window: Optional[int] = None,
                           chunk: int = DEFAULT_CHUNK,
                           bidirectional_prefix: int = 0) -> torch.Tensor:
    """Attention in the model layout on q's device: a CPU tensor is
    computed by :func:`flash_attention_plain` (with ``chunk``), a CUDA
    tensor by the CUDA kernel (its own tiles; ``chunk`` does not change the
    function)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     chunk=chunk,
                                     bidirectional_prefix=bidirectional_prefix)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    prefix=bidirectional_prefix)
    raise ValueError(f"no flash_attention for device {q.device}")

"""GQA attention (causal and/or sliding window, with an optional
bidirectional prefix) as CUDA kernels: the forward and its gradient.

Prefill and training hot spot of every attention family:
``models/attention.py::blockwise_attention`` calls
:func:`flash_attention_kernel` once per attention layer (self-attention,
whisper's encoder and cross-attention).  The hand-written forward kernel in
``csrc/flash_attention.cu`` replaces the JAX package's Pallas TPU kernel
``repro/kernels/flash_attention.py::_kernel``, launched there by
``flash_attention``.  The backward kernel in ``csrc/flash_attention_bwd.cu``
has no Pallas counterpart: the JAX package takes ``jax.grad`` of the jnp
``blockwise_attention``; the kernel computes that same gradient.

Layout: the model's, q ``[B, Sq, H, dh]`` and k/v ``[B, Sk, KV, dh]`` with
``H = KV * g`` (query head ``h`` reads kv head ``h // g``).  The kernels
take strides, so the public ``ops.flash_attention`` passes transposed
views of the JAX layout ``[B, H, S, dh]`` without a copy.

The function, on every path: scores ``q kᵀ`` with float32 accumulation,
times ``scale`` (the real ``dh ** -0.5`` unless the model gives its own,
as granite-4.0-h's 1/64); masked entries (above the diagonal, outside
the window, keys past ``Sk``) set to ``NEG_INF = -1e30``, except that a key
below ``bidirectional_prefix`` is visible to every query (the vlm family's
image tokens attend to each other both ways); a running max and
sum in float32 across key blocks; ``p`` rounded to the matmul dtype before
``p v``; the output divided by ``max(l, 1e-30)``, in the input dtype.

The functions:

* :func:`flash_attention_plain` — the reference's ``blockwise_attention``
  in plain torch (any device, any float dtype: the matmul inputs are
  rounded to the dtype of ``q``, bfloat16 on the model path as the
  reference casts them, float32 where a caller passes float32 as the
  Pallas body computes), optionally with the row log-sum-exp;
* :func:`flash_attention_bwd_plain` — the gradient in plain blockwise
  torch, the backward kernel's arithmetic (tests and ``chip_smoke.py``
  hold the kernel to it; nothing on the card's path calls it);
* :func:`flash_attention_cuda` — the forward kernel's wrapper, bfloat16
  CUDA tensors only; the kernel is compiled for :data:`HEAD_DIMS`, and the
  wrapper zero-pads any other dh up to 256 to the next of them
  (:func:`kernel_head_dim`, :func:`pad_head_dim`): zero columns of q and k
  add nothing to a score, zero columns of v give zero output columns,
  which it slices away, and it passes the scale of the real dh (or the
  caller's ``scale``).  It counts
  its launches in ``flash_attention_cuda.launches``;
* :func:`flash_attention_bwd_cuda` — the backward kernel's wrapper (two
  launches a call, counted once in ``flash_attention_bwd_cuda.launches``),
  padding dh as the forward's does;
* :class:`FlashAttention` — the ``torch.autograd.Function`` that joins the
  two kernels;
* :func:`flash_attention_kernel` — the dispatcher: a CPU tensor goes to the
  plain version (autograd differentiates it), a CUDA or meta tensor to the
  kernels (with the backward where grad is enabled), or an error;
* ``torch.ops.repro_torch.flash_attention`` and ``flash_attention_bwd`` —
  the two kernels as operators of torch's dispatcher, which the ``_cuda``
  wrappers call: the launch on the card, a fake implementation for fake
  and meta tensors (a ``FakeTensorMode`` trace) and a FLOP formula;
* :func:`live_entries`, :func:`attention_flops`,
  :func:`attention_bwd_flops` — the operation counts the FLOP formulas and
  ``chip_smoke.py``'s bounds share.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import OP_DEVICES, build, refuse_dtensor

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


#: products of 2 dh FLOPs per live score entry: the forward's (S = Q K^T,
#: O = P V), the ones the gradient needs (S and dP recomputed, dV, dK, dQ)
#: and the ones the backward kernel computes (its dQ kernel computes S and
#: dP again)
FWD_PRODUCTS, BWD_PRODUCTS, BWD_KERNEL_PRODUCTS = 2, 5, 7


def live_entries(S: int, sk: int, causal: bool, window: Optional[int],
                 prefix: int) -> int:
    """Unmasked score entries of one head: S queries over ``sk`` keys
    (causal and/or a sliding ``window``), keys below ``prefix`` visible to
    every query."""
    q = np.arange(S, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full(S, sk - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(S, np.int64)
    band = np.maximum(0, hi - lo + 1)
    pre = min(prefix, sk)
    both = np.maximum(0, np.minimum(pre - 1, hi) - lo + 1)
    return int((band + pre - both).sum())


def attention_flops(B: int, H: int, S: int, sk: int, dh: int, causal: bool,
                    window: Optional[int], prefix: int,
                    products: int = FWD_PRODUCTS) -> int:
    """FLOPs of ``products`` products of 2 dh each over the live score
    entries of B H heads.  The masked entries of the tiles the kernels visit
    on a mask's edge are computed but not counted."""
    return 2 * products * B * H * dh * live_entries(S, sk, causal, window,
                                                    prefix)


def attention_bwd_flops(B: int, H: int, S: int, sk: int, dh: int,
                        causal: bool, window: Optional[int], prefix: int,
                        products: int = BWD_KERNEL_PRODUCTS) -> int:
    """:func:`attention_flops` of the backward: the kernel's seven products
    by default, :data:`BWD_PRODUCTS` for what the gradient needs."""
    return attention_flops(B, H, S, sk, dh, causal, window, prefix, products)


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


def _blocks(Sq: int, Sk: int, chunk: int, causal: bool,
            window: Optional[int], prefix: int, device):
    """The block structure of the plain versions: ``(cq, sq_pad, ck, sk_pad,
    visits)`` where ``visits[qi]`` lists ``(kj, mask)`` for the key blocks
    that query block ``qi`` computes (``mask`` [cq, ck] bool, or None where
    every entry is live).  The reference's static block skipping and masks
    (``models/attention.py:96-178``), shared by the forward and the
    backward."""
    cq, sq_pad = pick_chunk(Sq, chunk)
    ck, sk_pad = pick_chunk(Sk, chunk)
    kv_limit = Sk if sk_pad != Sk else None   # mask padded keys
    nq, nk = sq_pad // cq, sk_pad // ck
    if not (prefix <= cq or nq == 1):
        raise ValueError(f"bidirectional prefix {prefix} must fit one chunk "
                         f"({cq})")
    visits = []
    for qi in range(nq):
        q_lo, q_hi = qi * cq, (qi + 1) * cq
        q_pos = torch.arange(q_lo, q_hi, device=device)
        row = []
        for kj in range(nk):
            k_lo, k_hi = kj * ck, (kj + 1) * ck
            if causal and k_lo > q_hi - 1:
                continue  # strictly-upper block: skipped
            if (window is not None and k_hi - 1 < q_lo - window + 1
                    and not (prefix and k_lo < prefix)):
                continue  # outside the sliding window: skipped
            k_pos = torch.arange(k_lo, k_hi, device=device)
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
            row.append((kj, mask))
        visits.append(row)
    return cq, sq_pad, ck, sk_pad, visits


def _pad_seq(t: torch.Tensor, s: int) -> torch.Tensor:
    """``t`` [B, S, ...] with zero rows appended up to ``s``."""
    extra = s - t.shape[1]
    if not extra:
        return t
    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, extra))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, window: Optional[int] = None,
                          chunk: int = DEFAULT_CHUNK,
                          bidirectional_prefix: int = 0,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """Block attention with static block skipping (the reference's
    ``blockwise_attention``, ``models/attention.py:96-178``).

    q: [B, Sq, H, dh]; k/v: [B, Sk, KV, dh].  Both are split into chunks;
    for each q chunk only the causally / window-wise reachable kv chunks
    are computed, combined by running-max softmax rescaling.  Positions
    below ``bidirectional_prefix`` attend to each other both ways (and,
    under a window, stay visible to every query); as in the reference the
    prefix must fit the first chunk.  ``scale`` defaults to ``dh ** -0.5``.
    Returns [B, Sq, H, dh] in q's dtype; with ``return_lse`` also the row
    log-sum-exp of the scaled scores, ``m + log(l)`` [B, H, Sq] float32, as
    the CUDA kernel writes it for the backward."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    cd = q.dtype
    cq, sq_pad, ck, sk_pad, visits = _blocks(
        Sq, Sk, chunk, causal, window, bidirectional_prefix, q.device)
    nq, nk = sq_pad // cq, sk_pad // ck
    if scale is None:
        scale = dh ** -0.5
    dev = q.device
    # Matmul inputs rounded to cd, products summed in float32.
    qg = _pad_seq(q, sq_pad).reshape(B, nq, cq, KV, g, dh).to(cd).float()
    kc = _pad_seq(k, sk_pad).reshape(B, nk, ck, KV, dh).to(cd).float()
    vc = _pad_seq(v, sk_pad).reshape(B, nk, ck, KV, dh).to(cd).float()

    out_chunks, lse_chunks = [], []
    for qi in range(nq):
        m = torch.full((B, KV, g, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, g, cq), dtype=torch.float32, device=dev)
        o = torch.zeros((B, KV, g, cq, dh), dtype=torch.float32, device=dev)
        for kj, mask in visits[qi]:
            s = torch.einsum("bqkgd,bckd->bkgqc", qg[:, qi], kc[:, kj]) * scale
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
        lse_chunks.append(m + torch.log(l))
    out = torch.stack(out_chunks, dim=1)  # [B, nq, KV, g, cq, dh]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, sq_pad, H, dh)
    out = out[:, :Sq].to(cd)
    if not return_lse:
        return out
    lse = torch.stack(lse_chunks, dim=3)  # [B, KV, g, nq, cq]
    return out, lse.reshape(B, H, sq_pad)[:, :, :Sq]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool, window: Optional[int] = None,
                              chunk: int = DEFAULT_CHUNK,
                              bidirectional_prefix: int = 0,
                              scale: Optional[float] = None):
    """The gradient of :func:`flash_attention_plain` (and of the CUDA
    kernel) with respect to q, k and v, in plain blockwise torch: the
    arithmetic of ``csrc/flash_attention_bwd.cu``.

    o: the forward's output; lse [B, H, Sq]: its row log-sum-exp; do: the
    output's gradient, shaped as o.  ``delta = rowsum(do * o)`` in float32;
    per visited block (the forward's skipping and masks) ``P = exp(S scale -
    lse)``, zero where masked, ``dV += P^T dO``, ``dS = P (dO V^T -
    delta)``, ``dQ += dS K scale``, ``dK += dS^T Q scale``, with P and dS
    rounded to q's dtype as product inputs and every sum in float32.
    Returns (dq, dk, dv) in the dtypes and shapes of q, k, v."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    cd = q.dtype
    cq, sq_pad, ck, sk_pad, visits = _blocks(
        Sq, Sk, chunk, causal, window, bidirectional_prefix, q.device)
    nq, nk = sq_pad // cq, sk_pad // ck
    if scale is None:
        scale = dh ** -0.5

    def rows(t, n, c, heads):  # [B, S, heads, dh] -> [B, n, c, KV, g, dh]
        return _pad_seq(t, n * c).reshape(B, n, c, KV, heads // KV,
                                          dh).to(cd).float()

    qg, dog = rows(q, nq, cq, H), rows(do, nq, cq, H)
    og = rows(o, nq, cq, H)
    kc, vc = (rows(t, nk, ck, KV)[:, :, :, :, 0] for t in (k, v))
    delta = torch.einsum("bnqkgd,bnqkgd->bnkgq", dog, og)  # [B,nq,KV,g,cq]
    lse_p = torch.nn.functional.pad(lse.float(), (0, sq_pad - Sq))
    lse_p = lse_p.reshape(B, KV, g, nq, cq).permute(0, 3, 1, 2, 4)
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(kc)
    dv = torch.zeros_like(vc)
    for qi in range(nq):
        for kj, mask in visits[qi]:
            s = torch.einsum("bqkgd,bckd->bkgqc", qg[:, qi], kc[:, kj]) * scale
            p = torch.exp(s - lse_p[:, qi, ..., None])
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            dv[:, kj] += torch.einsum("bkgqc,bqkgd->bckd", p.to(cd).float(),
                                      dog[:, qi])
            dp = torch.einsum("bqkgd,bckd->bkgqc", dog[:, qi], vc[:, kj])
            ds = (p * (dp - delta[:, qi, ..., None])).to(cd).float()
            dq[:, qi] += torch.einsum("bkgqc,bckd->bqkgd", ds,
                                      kc[:, kj]) * scale
            dk[:, kj] += torch.einsum("bkgqc,bqkgd->bckd", ds,
                                      qg[:, qi]) * scale
    dq = dq.reshape(B, sq_pad, H, dh)[:, :Sq]
    dk = dk.reshape(B, sk_pad, KV, dh)[:, :Sk]
    dv = dv.reshape(B, sk_pad, KV, dh)[:, :Sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------


def _library():
    """The built forward kernel's library with its C signature declared."""
    lib = build.load("flash_attention")
    if not getattr(lib, "_flash_attention_typed", False):
        lib.flash_attention_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._flash_attention_typed = True
    return lib


def _bwd_library():
    """The built backward kernels' library with its C signature declared."""
    lib = build.load("flash_attention_bwd")
    if not getattr(lib, "_flash_attention_bwd_typed", False):
        lib.flash_attention_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_void_p])
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        lib.flash_attention_bwd_scratch_floats.argtypes = [ctypes.c_int64] * 3
        lib.flash_attention_bwd_scratch_floats.restype = ctypes.c_int64
        lib._flash_attention_bwd_typed = True
    return lib


def _check_operand(name: str, t: torch.Tensor, device: torch.device,
                   fn: str = "flash_attention_cuda"):
    """Device, dtype, rank and strides of one operand; its base address is
    the launch's to check (:func:`_check_base`), as a fake tensor has
    none."""
    if not isinstance(t, torch.Tensor) or t.device.type not in OP_DEVICES:
        raise ValueError(f"{fn} takes CUDA tensors; {name} is "
                         f"on {getattr(t, 'device', type(t).__name__)}")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{fn} takes bfloat16; {name} is {t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"{fn}: {name} must be 4-D [B, S, heads, dh], got "
                         f"{tuple(t.shape)}")
    # 16-byte loads of 8 bf16 along dh: unit dh stride, other strides whole
    # 16-byte steps, 16-byte aligned base.
    if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"{fn}: {name} needs a unit head-dim stride, other "
                         "strides multiples of 8 elements and a 16-byte "
                         f"aligned base; got strides {t.stride()}")


def _check_base(fn: str, **named):
    """Raise unless every tensor of ``named`` starts 16-byte aligned."""
    for name, t in named.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} needs a unit head-dim stride, "
                             "other strides multiples of 8 elements and a "
                             f"16-byte aligned base; got base "
                             f"{t.data_ptr():#x}")


def _check_shapes(q, k, v, window, prefix, fn: str):
    """Validate q, k, v and the mask arguments; returns (B, Sq, H, dh, Sk,
    KV, the compiled dh)."""
    if not isinstance(q, torch.Tensor) or q.device.type not in OP_DEVICES:
        raise ValueError(f"{fn} takes CUDA tensors; q is on "
                         f"{getattr(q, 'device', type(q).__name__)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device, fn)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"{fn}: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"must be [B, Sk, KV, dh] with q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{fn}: {H} query heads over {KV} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"{fn}: window {window} < 1")
    if prefix < 0:
        raise ValueError(f"{fn}: prefix {prefix} < 0")
    return B, Sq, H, dh, Sk, KV, kernel_head_dim(dh)


def _check_bwd(q, k, v, o, lse, do, window, prefix, fn: str):
    """:func:`_check_shapes` and the backward's own operands o, do and
    lse; returns what it returns."""
    B, Sq, H, dh, Sk, KV, dk = _check_shapes(q, k, v, window, prefix, fn)
    for name, t in (("o", o), ("do", do)):
        _check_operand(name, t, q.device, fn)
        if t.shape != q.shape:
            raise ValueError(f"{fn}: {name} {tuple(t.shape)} must be shaped "
                             f"as q {tuple(q.shape)}")
    if (not isinstance(lse, torch.Tensor) or lse.device != q.device
            or lse.dtype != torch.float32 or lse.shape != (B, H, Sq)
            or not lse.is_contiguous()):
        raise ValueError(f"{fn}: lse must be a contiguous float32 [B, H, Sq] "
                         f"= {(B, H, Sq)} tensor on {q.device}")
    return B, Sq, H, dh, Sk, KV, dk


def _strides(*tensors) -> ctypes.Array:
    return (ctypes.c_int64 * (3 * len(tensors)))(
        *(s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))))


# ---------------------------------------------------------------------------
# The kernels as operators of torch's dispatcher (``torch.library``,
# namespace ``repro_torch``).  Each has a CUDA implementation (the launch),
# a fake one (the outputs' sizes, dtypes and strides, from the same
# allocation code, for FakeTensorMode and meta tensors) and a FLOP formula
# (``torch.utils.flop_counter``).  The wrappers below check the operands
# and call them; the dispatcher then sees every launch.  They are defined
# with ``Library.define`` rather than ``custom_op``, whose Python autograd
# layer costs several times the dispatch on every call; autograd is the
# ``FlashAttention`` Function's.
# ---------------------------------------------------------------------------

LIBRARY = torch.library.Library("repro_torch", "FRAGMENT")
LIBRARY.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
               "int? window, int prefix, bool return_lse, float? scale=None) "
               "-> (Tensor, Tensor)")
LIBRARY.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, "
               "Tensor lse, Tensor do, bool causal, int? window, int prefix, "
               "float? scale=None) -> (Tensor, Tensor, Tensor)")


def _scale(dh: int, scale: Optional[float]) -> float:
    """The scores' scale: ``scale``, or the real dh's ``dh ** -0.5``
    whatever the padding."""
    return float(dh ** -0.5 if scale is None else scale)


def _fwd_outputs(q: torch.Tensor, dh: int, return_lse: bool):
    """The forward's outputs as the launch allocates them, from q padded to
    the compiled dh: the output (q's strides where q is dense; its first
    ``dh`` columns, a view, where dh was padded) and the row log-sum-exp
    [B, H, Sq] float32, or an empty tensor without ``return_lse``."""
    B, Sq, H, dk = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq) if return_lse else (0,),
                      dtype=torch.float32, device=q.device)
    return out, (out[..., :dh] if dk != dh else out), lse


def _flash_attention_launch(q, k, v, causal, window, prefix, return_lse,
                            scale=None):
    """``repro_torch::flash_attention`` on the card: the launch, on
    operands :func:`flash_attention_cuda` has checked."""
    fn = "flash_attention_cuda"
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dk = kernel_head_dim(dh)
    _check_base(fn, q=q, k=k, v=v)
    scale = _scale(dh, scale)
    q, k, v = (pad_head_dim(t, dk) for t in (q, k, v))
    buf, out, lse = _fwd_outputs(q, dh, return_lse)
    if buf.numel() == 0:
        return out, lse
    lib = _library()
    shape = (ctypes.c_int64 * 6)(B, H, KV, Sq, Sk, dk)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(),
            lse.data_ptr() if return_lse else None, shape,
            _strides(q, k, v, buf), int(bool(causal)), int(window or 0),
            int(prefix), scale, stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    flash_attention_cuda.launches += 1
    return out, lse


def _flash_attention_fake(q, k, v, causal, window, prefix, return_lse,
                          scale=None):
    _, _, _, dh, _, _, dk = _check_shapes(q, k, v, window, prefix,
                                          "flash_attention_cuda")
    return _fwd_outputs(pad_head_dim(q, dk), dh, return_lse)[1:]


def _bwd_outputs(q, k, v, dh: int):
    """The backward's (dq, dk, dv) buffers as the launch allocates them,
    from q, k, v padded to the compiled dh, and the gradients returned:
    their first ``dh`` columns where dh was padded."""
    bufs = tuple(torch.empty_like(t) for t in (q, k, v))
    if q.shape[-1] != dh:
        return bufs, tuple(t[..., :dh] for t in bufs)
    return bufs, bufs


def _flash_attention_bwd_launch(q, k, v, o, lse, do, causal, window, prefix,
                                scale=None):
    """``repro_torch::flash_attention_bwd`` on the card: the two launches,
    on operands :func:`flash_attention_bwd_cuda` has checked."""
    fn = "flash_attention_bwd_cuda"
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dk = kernel_head_dim(dh)
    _check_base(fn, q=q, k=k, v=v, o=o, do=do)
    scale = _scale(dh, scale)
    q, k, v, o, do = (pad_head_dim(t, dk) for t in (q, k, v, o, do))
    (dq, dkey, dval), grads = _bwd_outputs(q, k, v, dh)
    if q.numel() == 0 or k.numel() == 0:
        for t in grads:
            t.zero_()
        return grads
    lib = _bwd_library()
    scratch = torch.empty(lib.flash_attention_bwd_scratch_floats(B, H, Sq),
                          dtype=torch.float32, device=q.device)
    shape = (ctypes.c_int64 * 6)(B, H, KV, Sq, Sk, dk)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
            dkey.data_ptr(), dval.data_ptr(), shape,
            _strides(q, k, v, o, do, dq, dkey, dval), int(bool(causal)),
            int(window or 0), int(prefix), scale, stream)
    if rc != 0:
        raise RuntimeError("flash_attention backward kernel launch failed: "
                           + lib.flash_attention_bwd_error_string(rc).decode())
    flash_attention_bwd_cuda.launches += 1
    return grads


def _flash_attention_bwd_fake(q, k, v, o, lse, do, causal, window, prefix,
                              scale=None):
    _, _, _, dh, _, _, dk = _check_bwd(q, k, v, o, lse, do, window, prefix,
                                       "flash_attention_bwd_cuda")
    return _bwd_outputs(*(pad_head_dim(t, dk) for t in (q, k, v)), dh)[1]


LIBRARY.impl("flash_attention", _flash_attention_launch, "CUDA")
LIBRARY.impl("flash_attention_bwd", _flash_attention_bwd_launch, "CUDA")
torch.library.register_fake("repro_torch::flash_attention",
                            _flash_attention_fake, lib=LIBRARY)
torch.library.register_fake("repro_torch::flash_attention_bwd",
                            _flash_attention_bwd_fake, lib=LIBRARY)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flop(q, k, v, causal, window, prefix, return_lse, *args,
                          **kwargs) -> int:
    """FLOPs of one forward launch: :func:`attention_flops` at the compiled
    dh (what the kernel computes)."""
    B, Sq, H, dh = q
    return attention_flops(B, H, Sq, k[1], kernel_head_dim(dh), causal,
                           window, prefix)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_attention_bwd_flop(q, k, v, o, lse, do, causal, window, prefix,
                              *args, **kwargs) -> int:
    """FLOPs of one backward call: :func:`attention_bwd_flops` with the
    kernel's seven products at the compiled dh."""
    B, Sq, H, dh = q
    return attention_bwd_flops(B, H, Sq, k[1], kernel_head_dim(dh), causal,
                               window, prefix)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int] = None,
                         prefix: int = 0, return_lse: bool = False,
                         scale: Optional[float] = None):
    """Launch ``csrc/flash_attention.cu`` (the op ``repro_torch::
    flash_attention``) on bfloat16 CUDA tensors q ``[B, Sq, H, dh]``, k/v
    ``[B, Sk, KV, dh]`` (any strides with a unit head-dim stride), keys
    below ``prefix`` visible to every query.  Returns the output with q's
    shape (q's strides where dh is compiled, else a slice of the padded
    output), still being computed on the current stream; with
    ``return_lse`` also the row log-sum-exp [B, H, Sq] float32 that
    :func:`flash_attention_bwd_cuda` takes.  Builds the kernel with
    ``nvcc`` at first use.  Raises on any other input, a dh above 256
    included, and if the launch is refused.  A fake or meta tensor runs
    the op's fake implementation: shapes only, nothing launched.  ``scale``
    multiplies the scores (None: ``dh ** -0.5``)."""
    _check_shapes(q, k, v, window, prefix, "flash_attention_cuda")
    out, lse = torch.ops.repro_torch.flash_attention.default(
        q, k, v, bool(causal), window, int(prefix), bool(return_lse), scale)
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool, window: Optional[int] = None,
                             prefix: int = 0, scale: Optional[float] = None):
    """Launch ``csrc/flash_attention_bwd.cu`` (the op ``repro_torch::
    flash_attention_bwd``: its two kernels, dQ with the row terms delta and
    lse, then dK/dV) on bfloat16 CUDA tensors: q, k, v as
    :func:`flash_attention_cuda` takes them, o and do shaped as q, lse the
    forward's [B, H, Sq] float32.  Returns (dq, dk, dv) shaped as q, k, v,
    still being computed on the current stream.  Zero-pads a dh that is not
    compiled, as the forward does.  ``scale`` is the forward's.  Counts one
    launch per call in ``flash_attention_bwd_cuda.launches``.  Raises on
    any other input and if a launch is refused."""
    _check_bwd(q, k, v, o, lse, do, window, prefix, "flash_attention_bwd_cuda")
    return torch.ops.repro_torch.flash_attention_bwd.default(
        q, k, v, o, lse, do, bool(causal), window, int(prefix), scale)


flash_attention_bwd_cuda.launches = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels take it: itself when its strides and base suit
    16-byte loads, else a contiguous copy (a gradient autograd hands over
    may be any view).  A fake or meta tensor has no base: its strides
    decide."""
    from torch._subclasses.fake_tensor import is_fake
    based = t.device.type == "meta" or is_fake(t) or t.data_ptr() % 16 == 0
    if t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:-1]) and based:
        return t
    return t.contiguous()


class FlashAttention(torch.autograd.Function):
    """Attention on the card with a gradient: the forward kernel, which also
    writes the row log-sum-exp, and the backward kernel.  The gradient is
    the JAX package's ``jax.grad`` of the same attention
    (``blockwise_attention``), computed by hand-written kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                prefix: int, scale: Optional[float] = None):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      prefix=prefix, return_lse=True,
                                      scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, prefix, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, prefix, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, o, lse, _aligned(do), causal=causal, window=window,
            prefix=prefix, scale=scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool, window: Optional[int] = None,
                           chunk: int = DEFAULT_CHUNK,
                           bidirectional_prefix: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attention in the model layout on q's device (scores times ``scale``,
    None: ``dh ** -0.5``): a CPU tensor is
    computed by :func:`flash_attention_plain` (with ``chunk``; autograd
    differentiates it), a CUDA tensor by the CUDA kernel (its own tiles;
    ``chunk`` does not change the function): through :class:`FlashAttention`
    and its backward kernel where grad is enabled and an input requires
    it, else the forward alone.  A meta tensor takes the kernels' custom ops
    as a CUDA tensor does, which run their fake implementations.  A DTensor
    input raises."""
    refuse_dtensor("flash_attention_kernel", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     chunk=chunk,
                                     bidirectional_prefix=bidirectional_prefix,
                                     scale=scale)
    if q.device.type in OP_DEVICES:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window,
                                        bidirectional_prefix, scale)
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    prefix=bidirectional_prefix, scale=scale)
    raise ValueError(f"no flash_attention for device {q.device}")

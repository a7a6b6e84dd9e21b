"""Mamba2 SSD (state-space duality) blocks: the chunked prefill scan
(through the ``ssd_scan`` kernel) and O(1)-state decode (arXiv:2405.21060).

Port of the JAX package's ``models/ssm.py`` on one card.  Per head h with
state size N and head dim P::

    s_t = exp(dt_t * A_h) * s_{t-1} + dt_t * B_t x_t^T      (s in R^{P x N})
    y_t = C_t s_t + D_h x_t

Prefill uses the chunked dual form (``ssd_chunked``; its jnp algorithm and
``segsum`` live beside the kernel, ``kernels/ssd_scan.py``); decode
carries ``(conv_state, ssm_state)`` per layer, constant in the sequence
length.  The block's depthwise causal conv with its bias and SiLU is
``kernels/causal_conv.py::causal_conv_kernel``: on the CPU the reference's
``_causal_conv`` in plain torch, on the card one hand-written kernel
forward and one backward (``csrc/causal_conv.cu``); decode's one-token
ring update stays plain torch.

Where the rules split ``inner`` over the model axis and it divides the SSM
heads (:func:`local_ssm_heads`), each rank computes its heads: from the
fused ``in_proj`` (z, x, B, C, dt under one ``inner`` axis, stored in the
reference's layout) this rank's heads' z, x and dt columns with B and C
whole (``partition.fused_product``), the depthwise conv runs on the
local channels (x's and all of B and C), the SSD kernel at ``H / m``
heads, the gated RMSNorm sums its squares over the ranks, and
``out_proj`` is row-parallel.  The decode state is this rank's channels
and heads.

Under a ``torch.profiler`` a block is the span ``model.ssm``
(``repro_torch.spans``) around ``ssm.conv`` (the depthwise conv and its
history; in ``mamba2_block`` its attr ``launches`` counts the conv
kernels' calls inside it, 0 on the plain path), ``ssm.scan`` (dt's
softplus, the SSD scan and the skip) and ``ssm.gate_norm`` (the gated
RMSNorm and ``out_proj``); ``in_proj`` is the rest of it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import causal_conv
from repro_torch.kernels.causal_conv import causal_conv_kernel
from repro_torch.kernels.ssd_scan import ssd_scan_kernel
from repro_torch import partition, spans
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import COMPUTE_DTYPE, ParamBuilder, Params, rms_norm


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba2(b: ParamBuilder, cfg: ModelConfig) -> Params:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    conv_dim = di + 2 * n  # conv over (x, B, C)
    return {
        # in_proj packs (z, x, B, C, dt)
        "in_proj": b.param((d, 2 * di + 2 * n + h), ("embed", "inner"),
                           scale=0.02),
        "conv_w": b.param((cfg.conv_width, conv_dim), (None, "inner"),
                          scale=0.02),
        "conv_b": b.param((conv_dim,), ("inner",), init="zeros"),
        "a_log": b.param((h,), (None,), init="uniform", scale=1.0),
        "d_skip": b.param((h,), (None,), init="ones"),
        "dt_bias": b.param((h,), (None,), init="zeros"),
        "norm": b.param((di,), ("inner",), init="zeros"),
        "out_proj": b.param((di, d), ("inner", "embed"), scale=0.02),
    }


def conv_weights(params: Params, share: partition.Share, cols=None):
    """A depthwise conv's weight [W, C] and bias in bf16 (the ssm and
    RG-LRU blocks' ``conv_w`` / ``conv_b``): this rank's shard of
    ``share``; with ``cols``, the channels of those (start, stop) ranges
    of the whole, each rank its own where ``share`` is split."""
    if cols is None:
        return (partition.wshard(params["conv_w"], COMPUTE_DTYPE,
                                 (None, "inner"), share),
                partition.wshard(params["conv_b"], COMPUTE_DTYPE,
                                 ("inner",), share))
    w = partition.wcast(params["conv_w"], COMPUTE_DTYPE, (None, "inner"),
                        sliced=share.split)
    b = partition.wcast(params["conv_b"], COMPUTE_DTYPE, ("inner",),
                        sliced=share.split)
    return partition.columns(w, cols), partition.columns(b, cols)


def _head_vector(params: Params, name: str,
                 heads: partition.Share) -> torch.Tensor:
    """A per-head vector (``a_log``, ``dt_bias``, ``d_skip``) in float32,
    the heads ``heads``."""
    v = partition.wcast(params[name], torch.float32, (None,),
                        sliced=heads.split)
    return v[heads.lo:heads.hi]


def local_ssm_heads(cfg: ModelConfig, count: bool = True) -> partition.Share:
    """This rank's SSM heads: split where the rules split ``inner`` evenly
    over the model axis in whole heads, else all of them (a split that
    does not divide counts a repeat when ``count``)."""
    return partition.shard_of("inner", cfg.n_ssm_heads,
                              "ssm" if count else None)


def _split_cols(cfg: ModelConfig, heads: partition.Share):
    """The column ranges of the heads ``heads`` in ``in_proj``'s fused
    (z, x, B, C, dt) output, and in the conv's (x, B, C) channels."""
    di, n, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    lo, hi = heads.lo, heads.hi
    z = (lo * p, hi * p)
    x = (di + lo * p, di + hi * p)
    bc = (2 * di, 2 * di + 2 * n)
    dt = (2 * di + 2 * n + lo, 2 * di + 2 * n + hi)
    conv = [(lo * p, hi * p), (di, di + 2 * n)]
    return [z, x, bc, dt], conv


def _gated_norm(y: torch.Tensor, params: Params, cfg: ModelConfig,
                heads: partition.Share) -> torch.Tensor:
    """``rms_norm`` over the ``d_inner`` channels, of which this rank holds
    ``y``'s (those of ``heads``) and the scale's: where they are split, the
    sum of squares summed over the model axis (both ways: each rank
    normalises its own channels with it)."""
    scale = partition.wshard(params["norm"], params["norm"].dtype,
                             ("inner",), heads)
    if not heads.split:
        return rms_norm(y, scale, cfg.norm_eps)
    dt = y.dtype
    y = y.float()
    ss = partition.model_sum(torch.sum(torch.square(y), dim=-1,
                                       keepdim=True), heads)
    y = y * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    return (y * (1.0 + scale.float())).to(dt)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  x: [B, S, H, P]; dt: [B, S, H] (softplus'd);
    a: [H] (negative); b_in/c_in: [B, S, N] (one group, shared by every
    head).  Returns (y [B, S, H, P], final_state [B, H, P, N] f32).

    On a CUDA tensor this is the hand-written ``ssd_scan`` kernel
    (``kernels/csrc/ssd_scan.cu``, the kernel the JAX package wrote in
    Pallas for this function), which takes its own chunk length, and where
    an input needs a gradient its backward kernel
    (``kernels/csrc/ssd_scan_bwd.cu``, through ``SSDScan``); on the CPU its
    plain torch version with ``chunk``, which autograd differentiates."""
    return ssd_scan_kernel(x, dt, a, b_in, c_in, chunk, init_state)


def ssd_reference(x, dt, a, b_in, c_in) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence oracle (tests), in float32."""
    B, S, H, P = x.shape
    N = b_in.shape[-1]
    x, dt, a = x.float(), dt.float(), a.float()
    b_in, c_in = b_in.float(), c_in.float()
    s = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * a)[..., None, None]          # [B,H,1,1]
        s = s * decay + torch.einsum("bhp,bn->bhpn",
                                     x[:, t] * dt[:, t, :, None], b_in[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", s, c_in[:, t]))
    return torch.stack(ys, dim=1), s


@spans.spanned("model.ssm")
def mamba2_block(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 return_state: bool = False):
    """Full mamba2 block.  x: [B, S, d].  ``state``: (conv_state
    [B, W-1, conv_dim], ssm_state [B, H, P, N]) to continue from, this
    rank's channels and heads.  Returns y or (y, new_state)."""
    B, S, d = x.shape
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    heads = local_ssm_heads(cfg)
    h = heads.hi - heads.lo
    cols, conv_cols = _split_cols(cfg, heads)
    zxbcdt = partition.fused_product(
        partition.copy_to_model(x, heads), params["in_proj"], COMPUTE_DTYPE,
        ("embed", "inner"), heads, cols)
    z, xbc, dt_raw = torch.split(zxbcdt, [h * p, h * p + 2 * n, h], dim=-1)

    conv_state, ssm_state = state if state is not None else (None, None)
    with spans.span("ssm.conv") as s:
        launched = causal_conv.launches()
        new_conv = (_conv_history(xbc, conv_state, cfg.conv_width)
                    if return_state else None)
        w, bias = conv_weights(params, heads, conv_cols)
        xbc = causal_conv_kernel(xbc, w, bias, conv_state)
        if s is not None:
            s.attrs["launches"] = causal_conv.launches() - launched

    with spans.span("ssm.scan"):
        xs, b_in, c_in = torch.split(xbc, [h * p, n, n], dim=-1)
        xs = partition.constrain(xs, ("batch", "seq", "inner"))
        xs = xs.reshape(B, S, h, p)   # a strided view: the kernel takes it
        a = -torch.exp(_head_vector(params, "a_log", heads))
        dt = softplus(dt_raw.float() + _head_vector(params, "dt_bias", heads))

        y, final_state = ssd_chunked(xs, dt, a, b_in, c_in, cfg.ssm_chunk,
                                     init_state=ssm_state)
        y = y + xs.float() * _head_vector(params, "d_skip", heads)[:, None]
        y = y.reshape(B, S, h * p).to(COMPUTE_DTYPE)

    with spans.span("ssm.gate_norm"):
        # gated RMSNorm then out projection
        y = _gated_norm(y * F.silu(z.float()).to(COMPUTE_DTYPE), params, cfg,
                        heads)
        out = partition.row_parallel(y, partition.wshard(
            params["out_proj"], COMPUTE_DTYPE, ("inner", "embed"), heads),
            heads)
    if return_state:
        return out, (new_conv.to(COMPUTE_DTYPE), final_state)
    return out


def _conv_history(xbc: torch.Tensor, conv_state, W: int) -> torch.Tensor:
    """The last ``W - 1`` conv inputs after ``xbc`` (left-padded)."""
    hist = xbc if conv_state is None else torch.cat(
        [conv_state.to(xbc.dtype), xbc], dim=1)
    if hist.shape[1] < W - 1:
        return F.pad(hist, (0, 0, W - 1 - hist.shape[1], 0))
    return hist[:, -(W - 1):, :]


@spans.spanned("model.ssm")
def mamba2_decode(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: Tuple[torch.Tensor, torch.Tensor]):
    """Single-token decode.  x: [B, d]; state as in :func:`mamba2_block`.
    Fully recurrent: O(1) in the sequence length.  Returns
    (out [B, d], (new_conv, new_ssm))."""
    B, d = x.shape
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    conv_state, ssm_state = state
    heads = local_ssm_heads(cfg)
    h = heads.hi - heads.lo
    di = h * p
    cols, conv_cols = _split_cols(cfg, heads)
    zxbcdt = partition.fused_product(x, params["in_proj"], COMPUTE_DTYPE,
                                     ("embed", "inner"), heads, cols)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * n, h], dim=-1)

    with spans.span("ssm.conv"):
        w, bias = conv_weights(params, heads, conv_cols)
        # conv ring update
        hist = torch.cat([conv_state.to(xbc.dtype), xbc[:, None, :]], dim=1)
        new_conv = hist[:, 1:, :]
        conv_out = torch.sum(hist * w[None], dim=1) + bias
        xbc = F.silu(conv_out.float()).to(COMPUTE_DTYPE)

    with spans.span("ssm.scan"):
        xs, b_in, c_in = torch.split(xbc, [di, n, n], dim=-1)
        xs = xs.reshape(B, h, p)
        a = -torch.exp(_head_vector(params, "a_log", heads))
        dt = softplus(dt_raw.float()
                      + _head_vector(params, "dt_bias", heads))      # [B, h]

        decay = torch.exp(dt * a)[..., None, None]                # [B,h,1,1]
        upd = torch.einsum("bhp,bn->bhpn", xs.float() * dt[..., None],
                           b_in.float())
        new_ssm = ssm_state * decay + upd
        y = torch.einsum("bhpn,bn->bhp", new_ssm, c_in.float())
        y = y + xs.float() * _head_vector(params, "d_skip", heads)[:, None]
        y = y.reshape(B, di).to(COMPUTE_DTYPE)
    with spans.span("ssm.gate_norm"):
        y = _gated_norm(y * F.silu(z.float()).to(COMPUTE_DTYPE), params, cfg,
                        heads)
        out = partition.row_parallel(y, partition.wshard(
            params["out_proj"], COMPUTE_DTYPE, ("inner", "embed"), heads),
            heads)
    return out, (new_conv, new_ssm)


def init_mamba2_state(cfg: ModelConfig, batch: int, device=None):
    """Zeroed decode state: (conv [B, W-1, conv_dim] bf16,
    ssm [B, H, P, N] f32); this rank's heads' under a split of them."""
    heads = local_ssm_heads(cfg, count=False)
    h = heads.hi - heads.lo
    conv_dim = h * cfg.ssm_head_dim + 2 * cfg.ssm_state
    conv = torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                       dtype=COMPUTE_DTYPE, device=device)
    ssm = torch.zeros((batch, h, cfg.ssm_head_dim,
                       cfg.ssm_state), dtype=torch.float32, device=device)
    return conv, ssm

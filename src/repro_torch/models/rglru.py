"""RG-LRU recurrent blocks (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of the JAX package's ``models/rglru.py`` on one card.  The recurrence
is a gated diagonal linear RNN::

    r_t = sigmoid(W_a x_t + b_a)           (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)           (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t) (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ x_t)

The reference runs it with ``jax.lax.associative_scan``; here
:func:`rglru_scan` is the same parallel prefix in float32 torch, log2(S)
doubling steps over the whole sequence (no Python loop over tokens), and no
kernel of its own: the reference has no Pallas kernel for it.  Decode is one
element-wise update of an O(1) state.

The full recurrent block (as in Griffin) is two branches: a GeLU gate
branch, and a (linear -> causal conv1d -> RG-LRU) branch, merged
multiplicatively and projected back to ``d_model``.

Where the rules split ``inner`` evenly over the model axis, each rank
computes its channels: ``w_gate`` / ``w_in`` column-parallel, the conv and
the recurrence on the local channels (both are per channel), the gates'
``wa`` / ``wx`` (which read every channel) on the conv output gathered over
the axis for this rank's output channels, and ``w_out`` row-parallel.  The
decode state is this rank's channels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import partition
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import COMPUTE_DTYPE, ParamBuilder, Params
from repro_torch.models.ssm import conv_weights, softplus

C_FACTOR = 8.0


def init_rglru_block(b: ParamBuilder, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    r = cfg.rnn_width_
    return {"w_gate": b.param((d, r), ("embed", "inner"), scale=0.02),
            "w_in": b.param((d, r), ("embed", "inner"), scale=0.02),
            "conv_w": b.param((cfg.conv_width, r), (None, "inner"),
                              scale=0.02),
            "conv_b": b.param((r,), ("inner",), init="zeros"),
            # RG-LRU gates (first dim replicated: both dims on the model
            # axis would double-assign the mesh axis)
            "wa": b.param((r, r), (None, "inner"), scale=0.02),
            "ba": b.param((r,), ("inner",), init="zeros"),
            "wx": b.param((r, r), (None, "inner"), scale=0.02),
            "bx": b.param((r,), ("inner",), init="zeros"),
            "lam": b.param((r,), ("inner",), init="uniform", scale=1.0),
            "w_out": b.param((r, d), ("inner", "embed"), scale=0.02)}


def _gates(params: Params, x: torch.Tensor,
           share: Optional[partition.Share] = None):
    """(a_t, beta_t * i_t ⊙ x_t) for the linear recurrence, in float32;
    ``x`` holds the channels ``share`` (all of them by default), and so do
    the results: ``wa`` / ``wx`` read every channel, so they take ``x``
    gathered over the model axis where the channels are split."""
    share = share or partition.Share("inner", 0, x.shape[-1])

    def f32(name, axes):
        return partition.wshard(params[name], torch.float32, axes, share)

    xw = partition.gather_model(x, -1, share).float()
    xf = x.float()
    r_gate = torch.sigmoid(xw @ f32("wa", (None, "inner"))
                           + f32("ba", ("inner",)))
    i_gate = torch.sigmoid(xw @ f32("wx", (None, "inner"))
                           + f32("bx", ("inner",)))
    log_a = -C_FACTOR * softplus(f32("lam", ("inner",))) * r_gate
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, beta * i_gate * xf


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, as a parallel
    prefix (Hillis-Steele): after the step of stride s every position holds
    the composition of the s * 2 steps that end there."""
    S = a.shape[1]
    s = 1
    while s < S:
        # Out of place, so autograd can differentiate the scan (training).
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        if 2 * s < S:  # the last step needs no gains
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def rglru_scan(params: Params, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               share: Optional[partition.Share] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU over a sequence.  x: [B, S, r] -> (h [B, S, r] in x's
    dtype, h_last [B, r] float32); ``share``: the channels ``x`` holds."""
    a, b_term = _gates(params, x, share)
    if h0 is not None:
        # The initial state as a virtual step 0 with gain 1.
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b_term = torch.cat([h0.float()[:, None], b_term], dim=1)
    h = _linear_scan(a, b_term)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(x.dtype), h[:, -1]


def rglru_step(params: Params, x: torch.Tensor, h_prev: torch.Tensor,
               share: Optional[partition.Share] = None) -> torch.Tensor:
    """One decode step.  x: [B, r]; h_prev: [B, r] -> h [B, r] float32;
    ``share``: the channels ``x`` holds."""
    a, b_term = _gates(params, x[:, None, :], share)
    return a[:, 0] * h_prev.float() + b_term[:, 0]


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    W = w.shape[0]
    if state is None:
        x_pad = F.pad(x, (0, 0, W - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = x_pad[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + x_pad[:, i:i + S] * w[i]
    return out + bias


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form) in float32, back to bf16."""
    return F.gelu(x.float(), approximate="tanh").to(COMPUTE_DTYPE)


def recurrent_block(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    return_state: bool = False):
    """Griffin recurrent block.  x: [B, S, d]; ``state``: (conv_state
    [B, W-1, r], h [B, r]), this rank's channels.  Returns y [B, S, d],
    and with ``return_state`` also the state after the last token."""
    conv_state, h0 = state if state is not None else (None, None)
    share = local_channels(cfg)
    x = partition.copy_to_model(x, share)
    gate = _gelu(x @ _read(params["w_gate"], ("embed", "inner"), share))
    u = x @ _read(params["w_in"], ("embed", "inner"), share)
    u = partition.constrain(u, ("batch", "seq", "inner"))

    new_conv = None
    if return_state:
        W = cfg.conv_width
        hist = u if conv_state is None else torch.cat(
            [conv_state.to(u.dtype), u], dim=1)
        if hist.shape[1] < W - 1:
            hist = F.pad(hist, (0, 0, W - 1 - hist.shape[1], 0))
        new_conv = hist[:, -(W - 1):]
    u = _causal_conv(u, *conv_weights(params, share), conv_state)

    h, h_last = rglru_scan(params, u, h0, share)
    y = partition.row_parallel(
        h * gate, _read(params["w_out"], ("inner", "embed"), share), share)
    if return_state:
        return y, (new_conv.to(COMPUTE_DTYPE), h_last)
    return y


def recurrent_block_decode(params: Params, x: torch.Tensor, cfg: ModelConfig,
                           state: Tuple[torch.Tensor, torch.Tensor]):
    """One-token decode.  x: [B, d] -> (y [B, d], new (conv, h) state)."""
    conv_state, h_prev = state
    share = local_channels(cfg)
    gate = _gelu(x @ _read(params["w_gate"], ("embed", "inner"), share))
    u = x @ _read(params["w_in"], ("embed", "inner"), share)
    hist = torch.cat([conv_state.to(u.dtype), u[:, None, :]], dim=1)
    w, bias = conv_weights(params, share)
    u = torch.sum(hist * w[None], dim=1) + bias
    h = rglru_step(params, u, h_prev, share)
    y = partition.row_parallel(
        h.to(COMPUTE_DTYPE) * gate,
        _read(params["w_out"], ("inner", "embed"), share), share)
    return y, (hist[:, 1:], h)


def local_channels(cfg: ModelConfig, count: bool = True) -> partition.Share:
    """This rank's RG-LRU channels: split where the rules split ``inner``
    evenly over the model axis, else all of them (a split that does not
    divide counts a repeat when ``count``)."""
    return partition.shard_of("inner", cfg.rnn_width_,
                              "rglru" if count else None)


def _read(w: torch.Tensor, axes, share: partition.Share) -> torch.Tensor:
    """The bf16 read of one of the block's matrices: this rank's shard of
    ``share``."""
    return partition.wshard(w, COMPUTE_DTYPE, axes, share)


def init_rglru_state(cfg: ModelConfig, batch: int, device=None):
    """Zeroed (conv [B, W-1, r] bf16, h [B, r] float32); this rank's
    channels under a split of them."""
    share = local_channels(cfg, count=False)
    r = share.hi - share.lo
    return (torch.zeros((batch, cfg.conv_width - 1, r), dtype=COMPUTE_DTYPE,
                        device=device),
            torch.zeros((batch, r), dtype=torch.float32, device=device))


def rglru_reference(params: Params, x: torch.Tensor,
                    h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential-scan oracle for :func:`rglru_scan` (tests)."""
    a, b_term = _gates(params, x)
    B, S, r = x.shape
    h = (torch.zeros((B, r), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    out = []
    for t in range(S):
        h = a[:, t] * h + b_term[:, t]
        out.append(h)
    return torch.stack(out, dim=1).to(x.dtype)

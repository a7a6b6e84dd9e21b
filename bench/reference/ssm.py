"""Plain float32 reference of Mamba-2 (mamba2-370m, arXiv:2405.21060): pre-norm
RMSNorm blocks of the SSD mixer, a final RMSNorm, the output head tied to
the embedding.

The mixer, per the paper: one input projection to (z, x, B, C, dt); a causal
depthwise convolution with bias and SiLU over (x, B, C); per head h,
``A_h = -exp(a_log_h)``, ``dt = softplus(dt + dt_bias)`` and the scan

    s_t = exp(dt_t A_h) s_{t-1} + dt_t x_t B_t^T,    y_t = C_t s_t + D_h x_t

(one group: B and C shared by every head); the gate ``y * silu(z)``, an
RMSNorm over the inner channels, the output projection.  The scan here is
the paper's chunked form, exact in float32: within a chunk the masked
``(C B^T) * L`` product, between chunks the state carried.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.common import Prec, rms_norm

CHUNK = 64


def padded_vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 256) * 256


def sizes(m: dict):
    """(d_inner, state, head dim, heads, conv width)."""
    di = m["ssm_expand"] * m["d_model"]
    return di, m["ssm_state"], m["ssm_head_dim"], di // m["ssm_head_dim"], \
        m["conv_width"]


def param_specs(m: dict) -> List[Tuple[tuple, tuple, str]]:
    d, V = m["d_model"], padded_vocab(m)
    di, n, _, h, W = sizes(m)
    specs = [(("embed",), (V, d), "normal"),
             (("final_norm", "scale"), (d,), "zeros")]
    for i in range(m["n_layers"]):
        L = ("layers", i)
        specs += [(L + ("ln", "scale"), (d,), "zeros"),
                  (L + ("mixer", "in_proj"), (d, 2 * di + 2 * n + h), "normal"),
                  (L + ("mixer", "conv_w"), (W, di + 2 * n), "normal"),
                  (L + ("mixer", "conv_b"), (di + 2 * n,), "zeros"),
                  (L + ("mixer", "a_log"), (h,), "uniform"),
                  (L + ("mixer", "d_skip"), (h,), "ones"),
                  (L + ("mixer", "dt_bias"), (h,), "zeros"),
                  (L + ("mixer", "norm"), (di,), "zeros"),
                  (L + ("mixer", "out_proj"), (di, d), "normal")]
    return specs


def ssd(x, dt, A, Bm, C, chunk: int = CHUNK):
    """The scan's outputs y [B, S, H, P] (without the D term).  x: [B, S, H,
    P]; dt: [B, S, H]; A: [H]; Bm, C: [B, S, N]."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = -S % chunk
    if pad:  # dt = 0 carries the state through unchanged
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, C = F.pad(Bm, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xd = (x * dt[..., None]).view(Bsz, nc, chunk, H, P)
    cum = torch.cumsum((dt * A).view(Bsz, nc, chunk, H), dim=2)
    Bc, Cc = Bm.view(Bsz, nc, chunk, N), C.view(Bsz, nc, chunk, N)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # [b,c,i,j,h]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    L = torch.exp(diff.masked_fill(~causal, float("-inf")))
    M = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[..., None] * L
    y = torch.einsum("bcijh,bcjhp->bcihp", M, xd)
    decay = torch.exp(cum[:, :, -1:, :] - cum)                # [b,c,j,h]
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc, decay[..., None] * xd)
    carry = x.new_zeros(Bsz, H, P, N)
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * torch.exp(cum[:, c, -1])[..., None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)                   # [b,c,h,p,n]
    y = y + torch.einsum("bcin,bchpn->bcihp", Cc, entering) \
        * torch.exp(cum)[..., None]
    return y.reshape(Bsz, nc * chunk, H, P)[:, :S]


def _mixer(mp: dict, x: torch.Tensor, m: dict, prec: Prec) -> torch.Tensor:
    B, S, _ = x.shape
    di, n, p, h, W = sizes(m)
    z, xbc, dt = torch.split(prec.mm(x, mp["in_proj"]), [di, di + 2 * n, h],
                             dim=-1)
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(xp[:, i:i + S] * mp["conv_w"][i] for i in range(W))
    xbc = F.silu(conv + mp["conv_b"])
    xs, Bm, C = torch.split(xbc, [di, n, n], dim=-1)
    xs = xs.reshape(B, S, h, p)
    A = -torch.exp(mp["a_log"])
    dt = F.softplus(dt + mp["dt_bias"])
    y = ssd(xs, dt, A, Bm, C) + xs * mp["d_skip"][:, None]
    y = y.reshape(B, S, di) * F.silu(z)
    return prec.mm(rms_norm(y, mp["norm"], m["norm_eps"]), mp["out_proj"])


def _layer(lp: dict, x: torch.Tensor, m: dict, prec: Prec) -> torch.Tensor:
    return x + _mixer(lp["mixer"], rms_norm(x, lp["ln"]["scale"],
                                            m["norm_eps"]), m, prec)


def hidden(P: dict, tokens: torch.Tensor, m: dict, prec: Prec,
           train: bool = False) -> torch.Tensor:
    x = F.embedding(tokens, P["embed"])
    for lp in P["layers"]:
        if train:
            x = checkpoint(_layer, lp, x, m, prec, use_reentrant=False)
        else:
            x = _layer(lp, x, m, prec)
    return rms_norm(x, P["final_norm"]["scale"], m["norm_eps"])


def head(P: dict, m: dict) -> torch.Tensor:
    return P["embed"][:m["vocab_size"]].T

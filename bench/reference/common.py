"""Plain PyTorch pieces the references share: float32 math with TF32 off,
the fp8 rendering that serves as the control, norms, rotary embedding,
blocked attention, the cross-entropy, and AdamW with its schedule.

Nothing here imports the program: each function is written from the
published description of the block (and the optimizer's paper), not from
the program's code.  ``Prec`` carries the rendering: ``"fp32"`` is the
reference, ``"fp8"`` rounds both operands of every linear layer and of the
output head to float8 e4m3 with one scale a tensor (and their gradients to
e5m2), the step a lower-precision path would take.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def float32_highest() -> None:
    """Matrix products in float32 proper: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round8(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    s = fmax / amax
    return ((x * s).to(dtype).to(x.dtype) / s)


class _Fp8(torch.autograd.Function):
    """e4m3 in the forward, the gradient rounded to e5m2 in the backward."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, E5M2_MAX)


@dataclasses.dataclass(frozen=True)
class Prec:
    mode: str = "fp32"     # "fp32" | "fp8"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp8":
            return _Fp8.apply(a) @ _Fp8.apply(b)
        if self.mode != "fp32":
            raise ValueError(self.mode)
        return a @ b


FP32 = Prec("fp32")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) * (1 + scale): the scale is stored as an offset from 1."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + scale)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, the two halves of each head rotated as pairs
    (GPT-NeoX layout).  x: [B, S, H, dh]; pos: [S]."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = pos.float()[:, None] * inv                       # [S, dh/2]
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]      # [S, 1, dh/2]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q, k, v, q0: int, k0: int, window: Optional[int]):
    """Causal (and windowed) softmax attention of the queries at positions
    q0.. over the keys at k0..: q [B, bq, KV, g, dh], k/v [B, bk, KV, dh]."""
    bq, bk = q.shape[1], k.shape[1]
    s = torch.einsum("bqkgd,bckd->bkgqc", q, k) * q.shape[-1] ** -0.5
    qp = torch.arange(q0, q0 + bq, device=q.device)[:, None]
    kp = torch.arange(k0, k0 + bk, device=q.device)[None, :]
    ok = kp <= qp
    if window:
        ok = ok & (kp > qp - window)
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    return torch.einsum("bkgqc,bckd->bqkgd", p, v)


def attention(q, k, v, window: Optional[int], block: int = 512,
              save_memory: bool = False) -> torch.Tensor:
    """Causal grouped-query attention, keys within ``window`` positions
    (the query's own included), in blocks of ``block`` queries that each
    see only the keys they can reach.  q: [B, S, H, dh]; k/v: [B, S, KV,
    dh].  ``save_memory`` recomputes each block in the backward."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, dh)
    outs = []
    for q0 in range(0, S, block):
        q1 = min(q0 + block, S)
        k0 = max(0, q0 - window + 1) if window else 0
        args = (qg[:, q0:q1], k[:, k0:q1], v[:, k0:q1], q0, k0, window)
        if save_memory:
            outs.append(checkpoint(_attend_block, *args, use_reentrant=False))
        else:
            outs.append(_attend_block(*args))
    return torch.cat(outs, dim=1).reshape(B, S, H, dh)


def _nll_rows(x, head, labels, prec: Prec):
    logits = prec.mm(x, head)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def cross_entropy(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                  prec: Prec, rows: int = 4096) -> torch.Tensor:
    """Mean next-token cross-entropy of hidden states x [T, d] under the head
    [d, V] (the real vocabulary only), in blocks of ``rows`` recomputed in
    the backward."""
    total = x.new_zeros(())
    for r0 in range(0, x.shape[0], rows):
        total = total + checkpoint(_nll_rows, x[r0:r0 + rows], head,
                                   labels[r0:r0 + rows], prec,
                                   use_reentrant=False)
    return total / x.shape[0]


def cosine_lr(base: float, warmup: int, total: int, step: int,
              min_frac: float = 0.1) -> float:
    """Linear warm-up to ``base`` over ``warmup`` steps, then a cosine decay
    to ``min_frac * base`` at ``total``."""
    if step < warmup:
        return base * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * (min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * prog)))


@dataclasses.dataclass(frozen=True)
class AdamWSpec:
    """AdamW (Loshchilov and Hutter) with decoupled weight decay and
    global-norm clipping, as the traffic file states it."""
    lr: float
    warmup: int
    total: int
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    @staticmethod
    def of(mix: dict) -> "AdamWSpec":
        return AdamWSpec(**mix["optimizer"])


@torch.no_grad()
def adamw_step(spec: AdamWSpec, leaves: List[torch.Tensor],
               grads: List[torch.Tensor], m: List[torch.Tensor],
               v: List[torch.Tensor], count: int) -> torch.Tensor:
    """One AdamW step in place on ``leaves``, ``m`` and ``v``, the gradients
    clipped to ``clip_norm`` by their global norm.  Returns the norms of the
    clipped gradients, one a leaf."""
    gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
    scale = torch.clamp(spec.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cosine_lr(spec.lr, spec.warmup, spec.total, count)
    bc1, bc2 = 1 - spec.b1 ** count, 1 - spec.b2 ** count
    norms = []
    for p, g, mm_, vv in zip(leaves, grads, m, v):
        g = g * scale
        norms.append(torch.linalg.vector_norm(g))
        mm_.mul_(spec.b1).add_(g, alpha=1 - spec.b1)
        vv.mul_(spec.b2).addcmul_(g, g, value=1 - spec.b2)
        upd = (mm_ / bc1) / (torch.sqrt(vv / bc2) + spec.eps)
        p.sub_(lr * (upd + spec.weight_decay * p))
    return torch.stack(norms)

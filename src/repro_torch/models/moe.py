"""Mixture-of-Experts layer: top-k router with capacity-based dispatch.

Port of the JAX package's ``models/moe.py`` on one card.  The dispatch is
the GShard formulation: tokens are regrouped into ``[G, T, d]`` groups of
``T`` (at most :data:`DEFAULT_GROUP`) tokens, the router (float32) picks
``top_k`` experts per token, each expert takes at most ``C`` tokens of a
group in (token, k) priority order (the rest are dropped), and two one-hot
tensors ``dispatch`` / ``combine`` ``[G, T, E, C]`` move tokens into
per-expert buffers ``[E, G, C, d]`` and back.  The one-hots are built with
``scatter_`` rather than ``one_hot`` (whose int64 output would be four
times the float32 tensor at the serving batch's 16,384 tokens).

Aux losses (load balance plus 1e-3 router z-loss) are returned as the
reference returns them.  The matmul layer has no kernel of its own: the
expert products are torch matmuls, as the reference left them to XLA.

Where the rules split ``expert`` evenly over the model axis, expert
parallelism: every rank routes every token with the whole router (small,
and the same decisions on each rank), then dispatches to, computes and
combines only its own experts ``[E / m, G, C, d]``; the partial outputs are
summed over the axis.  The aux loss is the whole router's.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import partition, spans
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import COMPUTE_DTYPE, ParamBuilder, Params

DEFAULT_GROUP = 256


def init_moe(b: ParamBuilder, cfg: ModelConfig) -> Params:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    mult = 2 if cfg.mlp_type in ("swiglu", "geglu") else 1
    # Expert dim carries the model axis (EP); the per-expert ff dim must not
    # also map to "model", hence the separate "expert_ff" logical axis.
    return {"router": b.param((d, E), ("embed", "expert"), scale=0.02),
            "wi": b.param((E, d, mult * ff), ("expert", "embed", "expert_ff"),
                          scale=0.02),
            "wo": b.param((E, ff, d), ("expert", "expert_ff", "embed"),
                          scale=0.02)}


def _group(n_tokens: int, group: int) -> int:
    """Largest group size <= ``group`` dividing ``n_tokens``."""
    t = min(group, n_tokens)
    while n_tokens % t:
        t -= 1
    return t


def _capacity(t: int, k: int, n_experts: int, cf: float) -> int:
    return max(1, int(-(-(k * t * cf) // n_experts)))  # ceil


def _one_hot(idx: torch.Tensor, n: int, value: torch.Tensor) -> torch.Tensor:
    """``one_hot(idx, n) * value[..., None]`` in ``value``'s dtype."""
    out = torch.zeros(idx.shape + (n,), dtype=value.dtype, device=idx.device)
    return out.scatter_(-1, idx[..., None], value[..., None])


def moe_routing(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                group: int = DEFAULT_GROUP):
    """The router's decisions for x [B, S, d]: ``(gate [G, T, k] f32
    normalised, eidx [G, T, k] expert indices, pos [G, T, k] place in the
    expert's buffer, keep [G, T, k] bool, C, aux scalar)``."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * S
    T = _group(N, group)
    G = N // T
    C = _capacity(T, k, E, cfg.capacity_factor)
    xg = partition.constrain(x.reshape(G, T, d), ("batch", None, "act_embed"))

    router = partition.wcast(params["router"], torch.float32,
                             ("embed", "expert"))
    logits = xg.float() @ router                               # [G, T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, k, dim=-1)                  # [G, T, k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # Load balance (top-1 fraction against mean probability) + z-loss; the
    # two means over the whole batch, as the reference's over every group.
    load = partition.batch_mean(_one_hot(
        eidx[..., 0], E, torch.ones_like(gate[..., 0])).mean(dim=(0, 1)))
    importance = partition.batch_mean(probs.mean(dim=(0, 1)))
    aux = E * torch.sum(load * importance)
    aux = aux + 1e-3 * torch.square(torch.logsumexp(logits, dim=-1)).mean()

    # Position in the expert's buffer: tokens ahead in (t, k) order.
    sel = _one_hot(eidx, E, torch.ones(eidx.shape, dtype=torch.int32,
                                       device=x.device))   # [G, T, k, E]
    flat = sel.reshape(G, T * k, E)
    ahead = torch.cumsum(flat, dim=1) - flat
    pos = torch.sum(ahead.reshape(G, T, k, E) * sel, dim=-1)   # [G, T, k]
    return gate, eidx, pos, pos < C, C, aux


@spans.spanned("model.moe")
def moe_mlp(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
            group: int = DEFAULT_GROUP) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE MLP.  x: [B, S, d] -> ([B, S, d], aux loss scalar)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    gate, eidx, pos, keep, C, aux = moe_routing(params, x, cfg, group=group)
    G, T = gate.shape[:2]
    xg = x.reshape(G, T, d)
    # This rank's experts [lo, hi) (all of them unless the rules split
    # them): the rest of the tokens' choices are dropped here and kept by
    # their owners.
    share = partition.shard_of("expert", E, "moe")
    lo, hi = share.lo, share.hi
    mine = (eidx >= lo) & (eidx < hi)
    keep = keep & mine
    eidx = torch.where(mine, eidx - lo, 0)
    E = hi - lo
    gate = partition.copy_to_model(gate, share)
    xg = partition.copy_to_model(xg, share)

    # dispatch / combine one-hots, built per k to bound transients.
    flat_idx = eidx * C + torch.clamp(pos, max=C - 1)          # [G, T, k]
    dispatch = torch.zeros((G, T, E * C), dtype=COMPUTE_DTYPE,
                           device=x.device)
    combine = torch.zeros((G, T, E * C), dtype=torch.float32, device=x.device)
    for i in range(k):
        hot = _one_hot(flat_idx[..., i], E * C, keep[..., i].float())
        dispatch += hot.to(COMPUTE_DTYPE)
        combine += hot * gate[..., i, None]
        del hot

    # Expert buffers [E, G, C, d]: exact (each slot holds one token or 0).
    expert_in = torch.einsum("gtx,gtd->gxd", dispatch, xg.to(COMPUTE_DTYPE))
    expert_in = expert_in.reshape(G, E, C, d).permute(1, 0, 2, 3)
    expert_in = partition.constrain(expert_in, ("expert", "batch", None, None))
    wi = partition.wshard(params["wi"], COMPUTE_DTYPE,
                          ("expert", "embed", "expert_ff"), share)
    wo = partition.wshard(params["wo"], COMPUTE_DTYPE,
                          ("expert", "expert_ff", "embed"), share)
    h = expert_in.reshape(E, G * C, d) @ wi
    if cfg.mlp_type in ("swiglu", "geglu"):
        g_, u_ = torch.chunk(h, 2, dim=-1)
        act = (F.silu(g_.float()) if cfg.mlp_type == "swiglu"
               else F.gelu(g_.float(), approximate="tanh"))
        h = act.to(COMPUTE_DTYPE) * u_
    elif cfg.mlp_type == "squared_relu":
        h = torch.square(torch.relu(h))
    else:
        h = F.gelu(h.float(), approximate="tanh").to(COMPUTE_DTYPE)
    h = partition.constrain(h.reshape(E, G, C, -1),
                            ("expert", "batch", None, "expert_ff"))
    expert_out = h.reshape(E, G * C, -1) @ wo                  # [E, G*C, d]
    expert_out = expert_out.reshape(E, G, C, d).permute(1, 0, 2, 3)
    y = partition.row_parallel(combine.to(COMPUTE_DTYPE),
                               expert_out.reshape(G, E * C, d),
                               share)                          # [G, T, d]
    y = partition.constrain(y, ("batch", None, "act_embed"))
    return y.reshape(B, S, d), aux


def moe_mlp_dense_ref(params: Params, x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Oracle: every token through its top-k experts in float32, no
    capacity drop (the reference's ``moe_mlp_dense_ref``)."""
    B, S, d = x.shape
    k = cfg.top_k
    xf = x.reshape(B * S, d).float()
    probs = torch.softmax(xf @ params["router"].float(), dim=-1)
    gate, eidx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    wi, wo = params["wi"].float(), params["wo"].float()
    out = torch.zeros_like(xf)
    for i in range(k):
        h = torch.bmm(xf[:, None, :], wi[eidx[:, i]])[:, 0]
        if cfg.mlp_type in ("swiglu", "geglu"):
            g_, u_ = torch.chunk(h, 2, dim=-1)
            h = (F.silu(g_) if cfg.mlp_type == "swiglu"
                 else F.gelu(g_, approximate="tanh")) * u_
        elif cfg.mlp_type == "squared_relu":
            h = torch.square(torch.relu(h))
        else:
            h = F.gelu(h, approximate="tanh")
        out = out + gate[:, i, None] * torch.bmm(h[:, None, :],
                                                 wo[eidx[:, i]])[:, 0]
    return out.reshape(B, S, d).to(x.dtype)

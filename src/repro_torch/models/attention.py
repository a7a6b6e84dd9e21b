"""Attention: the blockwise prefill path (through the ``flash_attention``
kernel), GQA / sliding-window / QKV-bias / bidirectional-prefix variants,
cross-attention over encoder states, and one-token decode against a ring
cache or a fixed encoder cache, with a sequence-sharded flash-decode for
serving.

Port of the JAX package's ``models/attention.py``.  The blockwise algorithm
and its ``_pick_chunk`` live beside the kernel, as
``kernels/flash_attention.py::flash_attention_plain`` / ``pick_chunk``.
Weights are read through ``partition.wcast`` (a cast without rules; under
rules it also gathers a sharded weight).  The decode cache is updated in
place (the reference returns a new one): one resident ``[L, B, W, KV, dh]``
pair instead of a copy per step.

Where the rules split ``heads`` over the model axis and it divides the
query heads (:func:`local_heads`), each rank computes its heads (Megatron
tensor parallelism): ``wq`` column-parallel over whole heads, K/V for the
kv heads those query heads use (``h // (H / KV)``), the kernel at ``H /
m`` heads, ``wo`` row-parallel and the ranks' outputs summed.  Under
``fsdp_rules`` the kv projections are replicated on the model axis and
each rank takes the columns of its kv heads from the whole weight; under
``serve_rules`` they are split over it, and a rank whose kv heads are its
own shard reads that shard alone.  A prefill keeps every kv head for the
cache.  Otherwise every rank computes every head.

Under rules whose ``cache_seq`` axis maps to a mesh dim (``fsdp_rules``,
``serve_rules``: the model axis), each rank holds only its ``W / n`` slice
of the cache's positions.  Each rank computes a local (max, sum-exp,
weighted-V) triple over its slice, and the triples are combined with
``all_reduce`` (MAX, then SUM) on that mesh dim's group: no kv-head
divisibility constraint, and per-rank cache bytes are ``1 / n``.  The
insert writes only on the rank that owns the position, so no collective
touches the cache itself.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import partition, spans
from repro_torch.kernels.flash_attention import (DEFAULT_CHUNK, NEG_INF,
                                                 flash_attention_kernel)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, ParamBuilder, Params,
                                       apply_rope)


def init_attention(b: ParamBuilder, cfg: ModelConfig,
                   d_in: Optional[int] = None) -> Params:
    d = d_in or cfg.d_model
    p = {"wq": b.param((d, cfg.q_dim), ("embed", "heads")),
         "wk": b.param((d, cfg.kv_dim), ("embed", "kv")),
         "wv": b.param((d, cfg.kv_dim), ("embed", "kv")),
         "wo": b.param((cfg.q_dim, d), ("heads", "embed"))}
    if cfg.qkv_bias:
        p["bq"] = b.param((cfg.q_dim,), ("heads",), init="zeros")
        p["bk"] = b.param((cfg.kv_dim,), ("kv",), init="zeros")
        p["bv"] = b.param((cfg.kv_dim,), ("kv",), init="zeros")
    return p


def local_heads(cfg: ModelConfig, count: bool = True):
    """(share, klo, khi): this rank's query heads (a ``partition.Share``)
    and the kv heads ``[klo, khi)`` they use.  Split where the rules split
    ``heads`` evenly over the model axis, m ranks, and either m divides
    the kv heads (each rank whole groups) or they divide m (each rank
    inside one group), so that the kernel's own grouping of the local
    heads is the model's; else every head (a split that is not so counts
    a repeat when ``count``)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    block = "attention" if count else None
    share = partition.shard_of("heads", H, block)
    if share.split:
        m = H // (share.hi - share.lo)
        if KV % m and m % KV:
            if count:
                partition.count_repeat(block)
            share = partition.Share("heads", 0, H)
    g = H // KV
    return share, share.lo // g, (share.hi - 1) // g + 1


def _project_q(params: Params, x: torch.Tensor, cfg: ModelConfig,
               share: partition.Share):
    """The query heads ``share`` [B, S, H/m, dh] (column-parallel)."""
    B, S, _ = x.shape
    q = x @ partition.wshard(params["wq"], COMPUTE_DTYPE, ("embed", "heads"),
                             share)
    if "bq" in params:
        q = q + partition.wshard(params["bq"], COMPUTE_DTYPE, ("heads",),
                                 share)
    return q.reshape(B, S, -1, cfg.head_dim_)


def _kv_weights(params: Params, cfg: ModelConfig, heads):
    """(wk, wv, bk, bv) in bf16 for the kv heads ``[klo, khi)`` of
    ``heads`` (:func:`local_heads`; the biases None without them): the
    rank's own shard where the rules split ``kv`` so; else the columns of
    the whole weights (each rank its own where the query heads are split:
    a partial gradient)."""
    share, klo, khi = heads
    dh = cfg.head_dim_
    kv = partition.shard_of("kv", cfg.n_kv_heads)
    if kv.split and (kv.lo, kv.hi) == (klo, khi):
        def read(name, axes):
            return partition.wshard(params[name], COMPUTE_DTYPE, axes, kv)
    else:
        def read(name, axes):
            w = partition.wcast(params[name], COMPUTE_DTYPE, axes,
                                sliced=share.split)
            return w[..., klo * dh:khi * dh]
    bias = "bk" in params
    return (read("wk", ("embed", "kv")), read("wv", ("embed", "kv")),
            read("bk", ("kv",)) if bias else None,
            read("bv", ("kv",)) if bias else None)


def _project_kv_heads(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      heads):
    """K and V of the kv heads ``[klo, khi)`` of ``heads`` only: each
    [B, S, khi - klo, dh] (:func:`_kv_weights`)."""
    B, S, _ = x.shape
    wk, wv, bk, bv = _kv_weights(params, cfg, heads)
    k = x @ wk
    v = x @ wv
    if bk is not None:
        k = k + bk
        v = v + bv
    return (k.reshape(B, S, -1, cfg.head_dim_),
            v.reshape(B, S, -1, cfg.head_dim_))


def _project_qkv_heads(params: Params, x: torch.Tensor, cfg: ModelConfig,
                       heads):
    """The query heads of ``heads`` and their kv heads from one product
    with the three weights side by side, so that the gradient of ``x`` is
    one sum in float32 before it is rounded."""
    B, S, _ = x.shape
    dh = cfg.head_dim_
    share = heads[0]
    wq = partition.wshard(params["wq"], COMPUTE_DTYPE, ("embed", "heads"),
                          share)
    wk, wv, bk, bv = _kv_weights(params, cfg, heads)
    qkv = x @ torch.cat([wq, wk, wv], dim=1)
    if bk is not None:
        qkv = qkv + torch.cat([partition.wshard(
            params["bq"], COMPUTE_DTYPE, ("heads",), share), bk, bv])
    q, k, v = torch.split(qkv, [wq.shape[1], wk.shape[1], wv.shape[1]],
                          dim=-1)
    return (q.reshape(B, S, -1, dh), k.reshape(B, S, -1, dh),
            v.reshape(B, S, -1, dh))


def _project_kv_whole(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      share: partition.Share):
    """Every kv head's K and V [B, S, KV, dh] for a cache, where ``share``
    holds the query heads: the shards gathered over the model axis where
    the rules split ``kv`` evenly, else from the whole weights."""
    KV = cfg.n_kv_heads
    kv = partition.shard_of("kv", KV)
    k, v = _project_kv_heads(params, x, cfg, (share, kv.lo, kv.hi))
    return partition.gather_model(k, 2, kv), partition.gather_model(v, 2, kv)


def _out_rows(params: Params, out: torch.Tensor,
              share: partition.Share) -> torch.Tensor:
    """The row-parallel output projection of the heads ``share`` (out
    [..., H/m * dh]), summed over the model axis."""
    wo = partition.wshard(params["wo"], COMPUTE_DTYPE, ("heads", "embed"),
                          share)
    return partition.row_parallel(out, wo, share)


def _attend(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
            positions, causal: bool, window, rope: bool,
            bidirectional_prefix: int, kv_x=None, keep_kv: bool = False):
    """:func:`attention_with_kv` (or the cross-attention over ``kv_x``) on
    this rank's heads (:func:`local_heads`): (out [B, S, d], (k, v) of
    every kv head with ``keep_kv``, else None)."""
    B, S, _ = x.shape
    heads = local_heads(cfg)
    share, klo, khi = heads
    x = partition.copy_to_model(x, share)
    kept = None
    if kv_x is None and not keep_kv and share.split:
        q, k, v = _project_qkv_heads(params, x, cfg, heads)
    else:
        q = _project_q(params, x, cfg, share)
        if kv_x is not None:
            k, v = _project_kv_heads(params, partition.copy_to_model(
                kv_x, share), cfg, heads)
        else:
            k, v = _project_kv_whole(params, x, cfg, share)
    if rope and positions is not None and cfg.position_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if keep_kv:
        kept = (k, v)
        k, v = k[:, :, klo:khi], v[:, :, klo:khi]
    out = blockwise_attention(q, k, v, causal=causal, window=window,
                              bidirectional_prefix=bidirectional_prefix,
                              scale=cfg.attention_multiplier)
    out = partition.constrain(out.reshape(B, S, -1), ("batch", "seq", "heads"))
    return _out_rows(params, out, share), kept


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: Optional[int] = None,
                        chunk: int = DEFAULT_CHUNK,
                        bidirectional_prefix: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Block attention with static block skipping.  q: [B, Sq, H, dh];
    k/v: [B, Sk, KV, dh] (H = KV * group); positions below
    ``bidirectional_prefix`` attend both ways; the scores times ``scale``
    (None: ``dh ** -0.5``).  Returns [B, Sq, H, dh].

    On a CUDA tensor this is the hand-written ``flash_attention`` kernel
    (``kernels/csrc/flash_attention.cu``, the kernel the JAX package wrote
    in Pallas for this function); on the CPU its plain torch version, the
    reference's jnp algorithm with ``chunk``-sized blocks."""
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  chunk=chunk,
                                  bidirectional_prefix=bidirectional_prefix,
                                  scale=scale)


@spans.spanned("model.attention")
def attention(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: Optional[torch.Tensor] = None, causal: bool = True,
              window: Optional[int] = None, rope: bool = True,
              bidirectional_prefix: int = 0,
              kv_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full attention block (projections + blockwise core + output
    projection).  ``kv_x`` switches to cross-attention: keys and values
    from the encoder states, no rope, not causal.  The config's
    ``position_embedding`` "nope" leaves out rope too, and its
    ``attention_multiplier`` scales the scores."""
    return _attend(params, x, cfg, positions=positions,
                   causal=causal and kv_x is None, window=window,
                   rope=rope and kv_x is None,
                   bidirectional_prefix=bidirectional_prefix, kv_x=kv_x)[0]


def project_kv(params: Params, kv_x: torch.Tensor, cfg: ModelConfig):
    """Keys/values (no rope) from encoder states: each [B, Sk, KV, dh],
    every kv head on every rank."""
    return _project_kv_whole(params, kv_x, cfg,
                             local_heads(cfg, count=False)[0])


@spans.spanned("model.attention")
def attention_with_kv(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      positions: Optional[torch.Tensor] = None,
                      causal: bool = True, window: Optional[int] = None,
                      rope: bool = True, bidirectional_prefix: int = 0):
    """Like :func:`attention` but also returns the (post-rope) K/V for the
    decode cache: (out [B, S, d], (k, v) each [B, S, KV, dh], every kv
    head on every rank)."""
    return _attend(params, x, cfg, positions=positions, causal=causal,
                   window=window, rope=rope,
                   bidirectional_prefix=bidirectional_prefix, keep_kv=True)


def _cache_shards():
    """(rules, mesh dim name, shard count, this rank's shard) of the decode
    cache's ``cache_seq`` axis; (None, None, 1, 0) when it is not
    sharded."""
    rules = partition.current_rules()
    axis = rules.axis("cache_seq") if rules is not None else None
    if axis is None:
        return None, None, 1, 0
    if not isinstance(axis, str):
        raise ValueError(f"cache_seq over the mesh dims {axis}: one dim "
                         "only")
    return rules, axis, rules.size("cache_seq"), rules.index("cache_seq")


def local_window(window: int) -> int:
    """The positions of a ``window``-slot cache that this rank holds."""
    _, _, n, _ = _cache_shards()
    if window % n:
        raise ValueError(f"a cache of {window} positions does not split "
                         f"over {n} ranks")
    return window // n


def global_window(w_local: int) -> int:
    """The positions of a cache whose slice on this rank holds
    ``w_local``."""
    return w_local * _cache_shards()[2]


def pack_cache(k: torch.Tensor, v: torch.Tensor, window: int):
    """Lay prefill K/V [B, S, KV, dh] out as a ring cache of ``window``
    slots, ``slot = pos % window`` (the decode insert's convention): for
    S >= window the last ``window`` tokens land rotated by S % window; for
    S < window tokens sit at slots [0, S) with zeros above.  With a
    sharded ``cache_seq``, this rank's slice of the slots."""

    def one(c):
        S = c.shape[1]
        if S >= window:
            c = torch.roll(c[:, S - window:], shifts=S % window, dims=1)
        else:
            c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, window - S))
        s_local = local_window(window)
        i = _cache_shards()[3]
        return c[:, i * s_local:(i + 1) * s_local]

    return one(k), one(v)


def cache_insert(cache: torch.Tensor, new: torch.Tensor, pos: int,
                 ring: Optional[int] = None) -> torch.Tensor:
    """Write one token's K or V at position ``pos`` (mod ``ring`` for a
    sliding-window ring buffer), in place.  cache: [B, S_local, KV, dh],
    this rank's slice of the positions; new: [B, KV, dh].  With a sharded
    ``cache_seq`` only the rank that owns the position writes.  Returns
    ``cache``."""
    tgt = pos % ring if ring is not None else pos
    _, _, _, i = _cache_shards()
    s_local = cache.shape[1]
    rel = tgt - i * s_local
    if 0 <= rel < s_local:
        cache[:, rel] = new.to(cache.dtype)
    return cache


def _local_decode(q, k, v, cache_len, base, window, scale=None):
    """Decode-attention partial over one slice of the cache, the positions
    ``base + arange(S_local)``: (o, l, m), unnormalized.  q: [B, H, dh];
    k/v: [B, S_local, KV, dh]; the scores times ``scale`` (None: ``dh **
    -0.5``)."""
    B, H, dh = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, KV, g, dh)
    pos = base + torch.arange(k.shape[1], device=q.device)
    valid = pos < cache_len
    if window is not None:
        valid = valid & (pos >= cache_len - window)
    s = torch.einsum("bkgd,bckd->bkgc", qg.to(COMPUTE_DTYPE).float(),
                     k.to(COMPUTE_DTYPE).float()) * (
                         dh ** -0.5 if scale is None else scale)
    s = torch.where(valid, s, NEG_INF)
    m = torch.amax(s, dim=-1)                            # [B, KV, g]
    p = torch.exp(s - m[..., None])
    p = torch.where(valid, p, 0.0)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", p.to(COMPUTE_DTYPE).float(),
                     v.to(COMPUTE_DTYPE).float())
    return o, l, m


def decode_attention_sharded(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cache_len: int,
                             window: Optional[int] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Flash-decode over a sequence-sharded cache.  q: [B, H, dh]; k/v_cache:
    [B, S_local, KV, dh], this rank's slice of the positions (all of them
    without a sharded ``cache_seq``).  Each rank's partial is rescaled to
    the global max and summed over the ``cache_seq`` mesh dim's group."""
    rules, axis, n, i = _cache_shards()
    B, H, dh = q.shape
    s_local = k_cache.shape[1]
    o, l, m = _local_decode(q, k_cache, v_cache, cache_len, i * s_local,
                            window, scale)
    if axis is not None:
        group = rules.mesh.get_group(axis)
        m_glob = m.clone()
        dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
        corr = torch.exp(m - m_glob)
        l = l * corr
        o = o * corr[..., None]
        dist.all_reduce(l, group=group)
        dist.all_reduce(o, group=group)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, dh).to(q.dtype)


@spans.spanned("model.attention")
def decode_attn(params: Params, x: torch.Tensor, cfg: ModelConfig,
                k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
                window: int):
    """One-token self-attention against a ring cache of ``window``
    positions, updated in place.  x: [B, d]; k/v_cache: [B, W_local, KV,
    dh]; pos: the current position.  Returns (out [B, d], k_cache,
    v_cache)."""
    B = x.shape[0]
    posb = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    share = local_heads(cfg)[0]
    # This rank's query heads, gathered for the sequence-sharded decode
    # (which reads every head over its slice of positions); a new token's
    # every kv head, for whichever rank owns its slot.
    rope = cfg.position_embedding == "rope"
    q = _project_q(params, x[:, None], cfg, share)
    if rope:
        q = apply_rope(q, posb, cfg.rope_theta)
    q = partition.gather_model(q, 2, share)
    k, v = _project_kv_whole(params, x[:, None], cfg, share)
    if rope:
        k = apply_rope(k, posb, cfg.rope_theta)
    cache_insert(k_cache, k[:, 0], pos, ring=window)
    cache_insert(v_cache, v[:, 0], pos, ring=window)
    eff_len = min(pos + 1, window)
    out = decode_attention_sharded(q[:, 0], k_cache, v_cache, eff_len,
                                   scale=cfg.attention_multiplier)
    out = out[:, share.lo:share.hi].reshape(B, -1)
    return _out_rows(params, out, share), k_cache, v_cache


@spans.spanned("model.attention")
def decode_cross_attn(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """One-token cross-attention over a fixed encoder cache.  x: [B, d];
    xk/xv: [B, F, KV, dh] (whole on every rank).  Returns [B, d]."""
    B = x.shape[0]
    share, klo, khi = local_heads(cfg)
    dh = cfg.head_dim_
    q = _project_q(params, x[:, None], cfg, share)[:, 0]
    xk, xv = xk[:, :, klo:khi], xv[:, :, klo:khi]
    qg = q.reshape(B, khi - klo, -1, dh)
    s = torch.einsum("bkgd,bfkd->bkgf", qg.to(COMPUTE_DTYPE).float(),
                     xk.to(COMPUTE_DTYPE).float()) * (dh ** -0.5)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgf,bfkd->bkgd", p.to(COMPUTE_DTYPE).float(),
                     xv.to(COMPUTE_DTYPE).float())
    return _out_rows(params, o.reshape(B, -1).to(x.dtype), share)


def init_decode_cache(cfg: ModelConfig, n_layers: int, batch: int,
                      max_seq: int, window: Optional[int] = None,
                      device=None):
    """Zeroed stacked KV cache pair, each [L, B, W_local, KV, dh] (W_local
    = W under no rules, this rank's ``W / n`` under a sharded
    ``cache_seq``), and its logical axes."""
    W = min(max_seq, window) if window else max_seq
    shape = (n_layers, batch, local_window(W), cfg.n_kv_heads, cfg.head_dim_)
    axes = ("layers", "batch", "cache_seq", None, None)
    return (torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
            torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)), axes

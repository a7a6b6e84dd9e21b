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

from repro_torch import partition
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


def _bias(params: Params, name: str, axis: str) -> torch.Tensor:
    return partition.wcast(params[name], COMPUTE_DTYPE, (axis,))


def _project_qkv(params: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor], rope: bool = True):
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = x @ partition.wcast(params["wq"], COMPUTE_DTYPE, ("embed", "heads"))
    k = x @ partition.wcast(params["wk"], COMPUTE_DTYPE, ("embed", "kv"))
    v = x @ partition.wcast(params["wv"], COMPUTE_DTYPE, ("embed", "kv"))
    if "bq" in params:
        q = q + _bias(params, "bq", "heads")
        k = k + _bias(params, "bk", "kv")
        v = v + _bias(params, "bv", "kv")
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, KV, dh)
    v = v.reshape(B, S, KV, dh)
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: Optional[int] = None,
                        chunk: int = DEFAULT_CHUNK,
                        bidirectional_prefix: int = 0) -> torch.Tensor:
    """Block attention with static block skipping.  q: [B, Sq, H, dh];
    k/v: [B, Sk, KV, dh] (H = KV * group); positions below
    ``bidirectional_prefix`` attend both ways.  Returns [B, Sq, H, dh].

    On a CUDA tensor this is the hand-written ``flash_attention`` kernel
    (``kernels/csrc/flash_attention.cu``, the kernel the JAX package wrote
    in Pallas for this function); on the CPU its plain torch version, the
    reference's jnp algorithm with ``chunk``-sized blocks."""
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  chunk=chunk,
                                  bidirectional_prefix=bidirectional_prefix)


def attention(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: Optional[torch.Tensor] = None, causal: bool = True,
              window: Optional[int] = None, rope: bool = True,
              bidirectional_prefix: int = 0,
              kv_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full attention block (projections + blockwise core + output
    projection).  ``kv_x`` switches to cross-attention: keys and values
    from the encoder states, no rope, not causal."""
    B, S, _ = x.shape
    if kv_x is None:
        return attention_with_kv(params, x, cfg, positions=positions,
                                 causal=causal, window=window, rope=rope,
                                 bidirectional_prefix=bidirectional_prefix)[0]
    q, _, _ = _project_qkv(params, x, cfg, positions, rope=False)
    k, v = project_kv(params, kv_x, cfg)
    out = blockwise_attention(q, k, v, causal=False, window=window,
                              bidirectional_prefix=bidirectional_prefix)
    out = partition.constrain(out.reshape(B, S, cfg.q_dim),
                              ("batch", "seq", "heads"))
    return out @ partition.wcast(params["wo"], COMPUTE_DTYPE,
                                 ("heads", "embed"))


def project_kv(params: Params, kv_x: torch.Tensor, cfg: ModelConfig):
    """Keys/values (no rope) from encoder states: each [B, Sk, KV, dh]."""
    B, Sk, _ = kv_x.shape
    k = kv_x @ partition.wcast(params["wk"], COMPUTE_DTYPE, ("embed", "kv"))
    v = kv_x @ partition.wcast(params["wv"], COMPUTE_DTYPE, ("embed", "kv"))
    if "bk" in params:
        k = k + _bias(params, "bk", "kv")
        v = v + _bias(params, "bv", "kv")
    return (k.reshape(B, Sk, cfg.n_kv_heads, cfg.head_dim_),
            v.reshape(B, Sk, cfg.n_kv_heads, cfg.head_dim_))


def attention_with_kv(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      positions: Optional[torch.Tensor] = None,
                      causal: bool = True, window: Optional[int] = None,
                      rope: bool = True, bidirectional_prefix: int = 0):
    """Like :func:`attention` but also returns the (post-rope) K/V for the
    decode cache: (out [B, S, d], (k, v) each [B, S, KV, dh])."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions, rope)
    out = blockwise_attention(q, k, v, causal=causal, window=window,
                              bidirectional_prefix=bidirectional_prefix)
    out = partition.constrain(out.reshape(B, S, cfg.q_dim),
                              ("batch", "seq", "heads"))
    return out @ partition.wcast(params["wo"], COMPUTE_DTYPE,
                                 ("heads", "embed")), (k, v)


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


def _local_decode(q, k, v, cache_len, base, window):
    """Decode-attention partial over one slice of the cache, the positions
    ``base + arange(S_local)``: (o, l, m), unnormalized.  q: [B, H, dh];
    k/v: [B, S_local, KV, dh]."""
    B, H, dh = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, KV, g, dh)
    pos = base + torch.arange(k.shape[1], device=q.device)
    valid = pos < cache_len
    if window is not None:
        valid = valid & (pos >= cache_len - window)
    s = torch.einsum("bkgd,bckd->bkgc", qg.to(COMPUTE_DTYPE).float(),
                     k.to(COMPUTE_DTYPE).float()) * (dh ** -0.5)
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
                             window: Optional[int] = None) -> torch.Tensor:
    """Flash-decode over a sequence-sharded cache.  q: [B, H, dh]; k/v_cache:
    [B, S_local, KV, dh], this rank's slice of the positions (all of them
    without a sharded ``cache_seq``).  Each rank's partial is rescaled to
    the global max and summed over the ``cache_seq`` mesh dim's group."""
    rules, axis, n, i = _cache_shards()
    B, H, dh = q.shape
    s_local = k_cache.shape[1]
    o, l, m = _local_decode(q, k_cache, v_cache, cache_len, i * s_local,
                            window)
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


def decode_attn(params: Params, x: torch.Tensor, cfg: ModelConfig,
                k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
                window: int):
    """One-token self-attention against a ring cache of ``window``
    positions, updated in place.  x: [B, d]; k/v_cache: [B, W_local, KV,
    dh]; pos: the current position.  Returns (out [B, d], k_cache,
    v_cache)."""
    B = x.shape[0]
    posb = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(params, x[:, None], cfg, posb, rope=True)
    cache_insert(k_cache, k[:, 0], pos, ring=window)
    cache_insert(v_cache, v[:, 0], pos, ring=window)
    eff_len = min(pos + 1, window)
    out = decode_attention_sharded(q[:, 0], k_cache, v_cache, eff_len)
    out = out.reshape(B, cfg.q_dim)
    wo = partition.wcast(params["wo"], COMPUTE_DTYPE, ("heads", "embed"))
    return out @ wo, k_cache, v_cache


def decode_cross_attn(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """One-token cross-attention over a fixed encoder cache.  x: [B, d];
    xk/xv: [B, F, KV, dh] (whole on every rank).  Returns [B, d]."""
    B = x.shape[0]
    q, _, _ = _project_qkv(params, x[:, None], cfg, None, rope=False)
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    qg = q[:, 0].reshape(B, KV, H // KV, dh)
    s = torch.einsum("bkgd,bfkd->bkgf", qg.to(COMPUTE_DTYPE).float(),
                     xk.to(COMPUTE_DTYPE).float()) * (dh ** -0.5)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgf,bfkd->bkgd", p.to(COMPUTE_DTYPE).float(),
                     xv.to(COMPUTE_DTYPE).float())
    out = o.reshape(B, cfg.q_dim).to(x.dtype)
    return out @ partition.wcast(params["wo"], COMPUTE_DTYPE,
                                 ("heads", "embed"))


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

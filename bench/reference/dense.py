"""Plain float32 reference of a dense decoder (h2o-danube-1.8b,
arXiv:2401.16818, a Mistral-style stack): pre-norm RMSNorm blocks of
grouped-query attention with rotary positions and a sliding window, and a
SwiGLU MLP; a final RMSNorm and an untied output head.

Parameters are the benchmark's (``param_specs``), in the layout the
program takes: the embedding and head are padded to a multiple of 256 rows
or columns, of which only the first ``vocab_size`` are read; the MLP's input
weight holds ``[gate | up]`` side by side.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.common import Prec, attention, rms_norm, rope


def padded_vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 256) * 256


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def param_specs(m: dict) -> List[Tuple[tuple, tuple, str]]:
    d, ff, V = m["d_model"], m["d_ff"], padded_vocab(m)
    q, kv = m["n_heads"] * head_dim(m), m["n_kv_heads"] * head_dim(m)
    specs = [(("embed",), (V, d), "normal"), (("head",), (d, V), "normal"),
             (("final_norm", "scale"), (d,), "zeros")]
    for i in range(m["n_layers"]):
        L = ("layers", i)
        specs += [(L + ("ln1", "scale"), (d,), "zeros"),
                  (L + ("attn", "wq"), (d, q), "normal"),
                  (L + ("attn", "wk"), (d, kv), "normal"),
                  (L + ("attn", "wv"), (d, kv), "normal"),
                  (L + ("attn", "wo"), (q, d), "normal"),
                  (L + ("ln2", "scale"), (d,), "zeros"),
                  (L + ("mlp", "wi"), (d, 2 * ff), "normal"),
                  (L + ("mlp", "wo"), (ff, d), "normal")]
    return specs


def _layer(lp: dict, x: torch.Tensor, m: dict, prec: Prec,
           save_memory: bool) -> torch.Tensor:
    B, S, _ = x.shape
    H, KV, dh = m["n_heads"], m["n_kv_heads"], head_dim(m)
    eps, theta = m["norm_eps"], m["rope_theta"]
    pos = torch.arange(S, device=x.device)
    a = lp["attn"]
    h = rms_norm(x, lp["ln1"]["scale"], eps)
    q = rope(prec.mm(h, a["wq"]).view(B, S, H, dh), pos, theta)
    k = rope(prec.mm(h, a["wk"]).view(B, S, KV, dh), pos, theta)
    v = prec.mm(h, a["wv"]).view(B, S, KV, dh)
    o = attention(q, k, v, m.get("sliding_window"), save_memory=save_memory)
    x = x + prec.mm(o.reshape(B, S, H * dh), a["wo"])
    h = rms_norm(x, lp["ln2"]["scale"], eps)
    gate, up = prec.mm(h, lp["mlp"]["wi"]).chunk(2, dim=-1)
    return x + prec.mm(F.silu(gate) * up, lp["mlp"]["wo"])


def hidden(P: dict, tokens: torch.Tensor, m: dict, prec: Prec,
           train: bool = False) -> torch.Tensor:
    """Final-norm hidden states [B, S, d] of token ids [B, S]; with
    ``train`` each layer is recomputed in the backward."""
    x = F.embedding(tokens, P["embed"])
    for lp in P["layers"]:
        if train:
            x = checkpoint(_layer, lp, x, m, prec, True, use_reentrant=False)
        else:
            x = _layer(lp, x, m, prec, False)
    return rms_norm(x, P["final_norm"]["scale"], m["norm_eps"])


def head(P: dict, m: dict) -> torch.Tensor:
    """The output head over the real vocabulary, [d, vocab_size]."""
    return P["head"][:, :m["vocab_size"]]

"""Plain float32 reference of a Mamba-2 + attention hybrid (granite-4.0-h-micro,
IBM Granite 4.0, ``granitemoehybrid`` without experts): pre-norm RMSNorm
layers whose mixer is a Mamba-2 SSD mixer or grouped-query attention, each
followed by a SwiGLU MLP; a final RMSNorm and the output head tied to the
embedding.

Per the published description (the model's ``config.json`` and its
modelling code), with h the hidden state and m the layer's mixer:

    h = embedding(ids) * embedding_multiplier
    h = h + residual_multiplier * m(rms(h))
    h = h + residual_multiplier * mlp(rms(h))
    logits = rms(h) @ embedding^T / logits_scaling

``layer_types`` is ``block_pattern`` repeated (no remainder).  The Mamba-2
mixer is ``bench/reference/ssm.py``'s (one group: its gated RMSNorm spans
all ``d_inner`` channels).  The attention has no position embedding
(``position_embedding_type`` "nope"), no biases, and scales its scores by
``attention_multiplier`` (1/64 at head dim 64, not 1/8).

Departures, each exact in float32: the attention is
``bench/reference/common.py``'s blocked attention, which scales by ``dh **
-0.5``, given q times ``attention_multiplier * dh ** 0.5`` (1/8 here, a
power of two); the logits' division is folded into the head matrix
(``head``), also by a power of two (8).

Parameters are the benchmark's (``param_specs``), in the layout the
program takes: ``layers`` a list of pattern units, each a list of the
unit's layers; the MLP's input weight holds ``[gate | up]`` side by side.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference import ssm
from bench.reference.common import Prec, attention, rms_norm


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def pattern(m: dict) -> List[str]:
    return list(m["block_pattern"])


def n_units(m: dict) -> int:
    units, rem = divmod(m["n_layers"], len(pattern(m)))
    if rem:
        raise ValueError("the layers are not whole pattern units")
    return units


def param_specs(m: dict) -> List[Tuple[tuple, tuple, str]]:
    d, ff, V = m["d_model"], m["d_ff"], ssm.padded_vocab(m)
    q, kv = m["n_heads"] * head_dim(m), m["n_kv_heads"] * head_dim(m)
    di, n, _, h, W = ssm.sizes(m)
    specs = [(("embed",), (V, d), "normal"),
             (("final_norm", "scale"), (d,), "zeros")]
    for u in range(n_units(m)):
        for j, kind in enumerate(pattern(m)):
            L = ("layers", u, j)
            specs.append((L + ("ln1", "scale"), (d,), "zeros"))
            B = L + ("block",)
            if kind == "mamba":
                specs += [(B + ("in_proj",), (d, 2 * di + 2 * n + h), "normal"),
                          (B + ("conv_w",), (W, di + 2 * n), "normal"),
                          (B + ("conv_b",), (di + 2 * n,), "zeros"),
                          (B + ("a_log",), (h,), "uniform"),
                          (B + ("d_skip",), (h,), "ones"),
                          (B + ("dt_bias",), (h,), "zeros"),
                          (B + ("norm",), (di,), "zeros"),
                          (B + ("out_proj",), (di, d), "normal")]
            elif kind == "attn":
                specs += [(B + ("wq",), (d, q), "normal"),
                          (B + ("wk",), (d, kv), "normal"),
                          (B + ("wv",), (d, kv), "normal"),
                          (B + ("wo",), (q, d), "normal")]
            else:
                raise ValueError(f"no {kind!r} layer in this reference")
            specs += [(L + ("ln2", "scale"), (d,), "zeros"),
                      (L + ("mlp", "wi"), (d, 2 * ff), "normal"),
                      (L + ("mlp", "wo"), (ff, d), "normal")]
    return specs


def _attention(ap: dict, x: torch.Tensor, m: dict, prec: Prec,
               save_memory: bool) -> torch.Tensor:
    B, S, _ = x.shape
    H, KV, dh = m["n_heads"], m["n_kv_heads"], head_dim(m)
    q = prec.mm(x, ap["wq"]).view(B, S, H, dh)
    k = prec.mm(x, ap["wk"]).view(B, S, KV, dh)
    v = prec.mm(x, ap["wv"]).view(B, S, KV, dh)
    o = attention(q * (m["attention_multiplier"] * dh ** 0.5), k, v, None,
                  save_memory=save_memory)
    return prec.mm(o.reshape(B, S, H * dh), ap["wo"])


def _layer(lp: dict, x: torch.Tensor, m: dict, prec: Prec, kind: str,
           save_memory: bool) -> torch.Tensor:
    eps, r = m["norm_eps"], m["residual_multiplier"]
    h = rms_norm(x, lp["ln1"]["scale"], eps)
    if kind == "mamba":
        y = ssm._mixer(lp["block"], h, m, prec)
    else:
        y = _attention(lp["block"], h, m, prec, save_memory)
    x = x + r * y
    h = rms_norm(x, lp["ln2"]["scale"], eps)
    gate, up = prec.mm(h, lp["mlp"]["wi"]).chunk(2, dim=-1)
    return x + r * prec.mm(F.silu(gate) * up, lp["mlp"]["wo"])


def hidden(P: dict, tokens: torch.Tensor, m: dict, prec: Prec,
           train: bool = False) -> torch.Tensor:
    """Final-norm hidden states [B, S, d] of token ids [B, S]; with
    ``train`` each layer is recomputed in the backward."""
    x = F.embedding(tokens, P["embed"]) * m["embedding_multiplier"]
    for unit in P["layers"]:
        for lp, kind in zip(unit, pattern(m)):
            if train:
                x = checkpoint(_layer, lp, x, m, prec, kind, True,
                               use_reentrant=False)
            else:
                x = _layer(lp, x, m, prec, kind, False)
    return rms_norm(x, P["final_norm"]["scale"], m["norm_eps"])


def head(P: dict, m: dict) -> torch.Tensor:
    """The tied output head over the real vocabulary, divided by
    ``logits_scaling``: [d, vocab_size]."""
    return P["embed"][:m["vocab_size"]].T / m["logits_scaling"]

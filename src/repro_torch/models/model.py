"""The model's training and serving paths for every family of the JAX
package: ``dense``, ``moe``, ``ssm``, ``hybrid``, ``encdec`` and ``vlm``.

Port of the JAX package's ``models/model.py`` (``chunked_cross_entropy``;
``Model``: ``init``, ``forward``, ``loss_fn``, ``init_cache``,
``prefill``, ``decode_step``, ``head_matrix``, ``_mask_pad_logits``,
``cache_window``, ``_encode``, ``norm_kind``).
Parameters are a plain dict under the reference's key names.  Where the
reference stacks layers ``[L, ...]`` for ``lax.scan``, the port keeps a
list and a Python loop runs it: ``params["layers"]`` is a list of
per-layer dicts (for ``hybrid`` a list of pattern units, each a tuple of
per-layer dicts, with the remainder layers in the tuple
``params["rem_layers"]``; for ``encdec`` the decoder's, beside
``params["enc_layers"]``).  The decode caches keep the reference's stacked
layouts (``{"k", "v"}`` ``[L, B, W, KV, dh]``, ``{"conv", "ssm"}``, the
hybrid's ``{"units", "rem"}``, the encdec's ``{"k", "v", "xk", "xv"}``) and
``decode_step`` updates them in place.

Every attention prefill goes through the ``flash_attention`` kernel on the
card (whisper's encoder and cross-attention non-causal, the vlm image
prefix bidirectional), every SSD prefill through ``ssd_scan``.  Training
(``forward``, ``loss_fn``) runs the same attention through the kernel's
``torch.autograd.Function``, whose backward is a kernel too, and every SSD
layer through ``ssd_scan``'s (``SSDScan``), so every family trains on the
card.  Remat is one
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` per layer
(the hybrid's too, where the reference checkpoints a pattern unit: ten of
granite-4.0-h's layers recomputed at once at 16k tokens hold ~25 GB beside
its 51 GB of state) and per encoder layer, where the reference has its
per-layer ``jax.checkpoint``; its recompute runs under the forward's
``partition`` rules (``partition.recompute_context``).  The reference's
``stack_layers`` and ``_barrier`` (an ``optimization_barrier`` that fences
XLA's scheduling around the ``lax.scan`` carry) are artifacts of scanning
stacked weights: the port's Python loop over a list of layers needs
neither.

Under ``partition`` rules the parameters are ``DTensor``s, the activations
are this rank's shard of the batch, and the attention families' decode
cache is sharded on its positions (``models/attention.py``).  Where the
rules split a block's dim evenly over the model axis, each model-axis rank
computes its share of it: the attention's heads, the MLP's ff columns,
the experts, the SSM and RG-LRU inner channels, and the vocab (the
embedding lookup, the chunked cross-entropy and the logits, of which
``prefill`` and ``decode_step`` return this rank's columns: :meth:`Model.
greedy` takes the argmax across them, :meth:`Model.whole_logits` gathers
them).  The residual stream stays whole on every model rank.  Elsewhere a
weight is gathered at its use by ``partition.wcast`` and every rank
repeats the block.  ``param_axes`` gives the logical axes of every
parameter in the port's per-layer layout.

The hybrid family's pattern mixes RG-LRU (``"rec"``), Mamba-2 (``"mamba"``,
the ssm family's block) and attention (``"attn"``, windowed by
``local_window`` or, where it is None, full) layers, each followed by an
MLP, and keeps both kinds of decode state side by side in its cache.  The
port's own config fields (granite-4.0-h) apply in every family where they
are set: the embedding's multiplier, the residual multiplier of each mixer
and MLP output (hybrid), the attention's scale and position embedding
(``models/attention.py``) and the logits' divisor (the loss and
:meth:`Model._logits`).

Under a ``torch.profiler`` the blocks record spans (``repro_torch.spans``),
by the same names in training, prefill and decode: ``model.embed``,
``model.layer`` {``layer``; ``encoder`` for whisper's encoder layers;
``kind`` for a hybrid's}
around ``model.norm``, ``model.attention``, ``model.mlp`` or ``model.moe``
and ``model.ssm`` (``models/ssm.py``), and ``model.loss`` (the chunked
cross-entropy with its head product).  A remat layer's recompute records
its spans again, under ``train.backward``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import partition, spans
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, AxesBuilder,
                                       ParamBuilder, Params, ShapeBuilder,
                                       embed_lookup, init_mlp, layer_norm,
                                       mlp, rms_norm, sinusoidal_positions)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
CE_CHUNK = 512  # sequence chunk for the checkpointed cross-entropy
#: The residual stream's logical axes: this rank's batch, the whole rest.
ACT = ("batch", "seq", "act_embed")


def _ce_chunk(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor, valid_vocab: Optional[int],
              share: partition.Share, logits_scaling: float = 1.0):
    """(sum of the masked NLL, sum of the mask) of one sequence chunk;
    ``head`` holds the vocab columns ``share`` (where they are split over
    the model axis, the max, the sum of exponentials and the gold logit,
    which only its owner holds, are reduced over the ranks); the logits
    divided by ``logits_scaling`` where it is not 1."""
    logits = partition.constrain((x @ head).float(), ("batch", None, "vocab"))
    if logits_scaling != 1.0:
        logits = logits / logits_scaling
    lo, n = share.lo, logits.shape[-1]
    if valid_vocab is not None and valid_vocab < share.hi:
        vocab = torch.arange(lo, lo + n, device=logits.device)
        logits = torch.where(vocab >= valid_vocab, -1e30, logits)
    if share.split:
        top = partition.model_max(torch.amax(logits, dim=-1), share)
        lse = top + torch.log(partition.reduce_from_model(
            torch.sum(torch.exp(logits - top[..., None]), dim=-1), share))
    else:
        lse = torch.logsumexp(logits, dim=-1)
    own = (labels >= lo) & (labels < share.hi)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels - lo, 0, n - 1)[..., None])[..., 0]
    gold = partition.reduce_from_model(torch.where(own, gold, 0.0), share)
    return torch.sum((lse - gold) * mask), torch.sum(mask)


@spans.spanned("model.loss")
def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          chunk: int = CE_CHUNK,
                          valid_vocab: Optional[int] = None,
                          logits_scaling: float = 1.0) -> torch.Tensor:
    """Mean next-token CE; the logits are computed per sequence chunk under
    ``torch.utils.checkpoint``, so only one chunk's [B, c, V] float32
    logits is ever live (the backward recomputes them chunk by chunk).
    x: [B, S, d]; head: [d, V]; labels: [B, S]; mask broadcastable to
    [B, S].  The chunk is the largest power-of-two fraction of ``chunk``
    dividing S, and the sums run chunk after chunk, as the reference's
    scan does.  Where the rules split ``vocab`` evenly over the model axis,
    vocab-parallel: each rank computes the logits of its columns, and
    ``valid_vocab`` masks by global vocab index.  The logits are divided by
    ``logits_scaling`` (granite-4.0-h's 8) before the softmax."""
    B, S, _ = x.shape
    c = min(chunk, S)
    while S % c:
        c //= 2
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    mask = mask.float().expand(B, S)
    labels = labels.long()
    # One cast (and under rules one gather), shared by every chunk.
    share = partition.shard_of("vocab", head.shape[1], "cross_entropy")
    head = partition.wshard(head, COMPUTE_DTYPE, (None, "vocab"), share)
    x = partition.copy_to_model(x, share)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, S, c):
        nll, m = checkpoint(_ce_chunk, x[:, start:start + c], head,
                            labels[:, start:start + c],
                            mask[:, start:start + c], valid_vocab, share,
                            logits_scaling, use_reentrant=False,
                            context_fn=partition.recompute_context)
        tot = tot + nll
        cnt = cnt + m
    return tot / torch.clamp(cnt, min=1.0)


def _init_norm(b: ParamBuilder, d: int, kind: str) -> Params:
    if kind == "rms":
        return {"scale": b.param((d,), ("embed",), init="zeros")}
    return {"scale": b.param((d,), ("embed",), init="ones"),
            "bias": b.param((d,), ("embed",), init="zeros")}


@spans.spanned("model.norm")
def _norm(p: Params, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    scale = partition.gather(p["scale"])
    if kind == "rms":
        return rms_norm(x, scale, eps)
    return layer_norm(x, scale, partition.gather(p["bias"]), eps)


def _residual(x: torch.Tensor, y: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """``x + y``, ``y`` times the config's residual multiplier where it is
    not 1."""
    if cfg.residual_multiplier != 1.0:
        y = y * cfg.residual_multiplier
    return x + y


def _layer(fn, i: int, *args, **attrs):
    """``fn(*args)`` as the model's layer ``i`` (the ``model.layer`` span,
    with ``attrs``)."""
    with spans.span("model.layer", layer=i, **attrs):
        return fn(*args)


class Model:
    """One model of any family on one device.

    ``device=None`` is the CUDA card and raises without one
    (``kernels/ops.py::resolve_device``); pass ``device="cpu"`` to run the
    plain torch versions on the host."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family not in FAMILIES:
            raise ValueError(f"family {cfg.family!r} is none of {FAMILIES}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._paxes = None

    @property
    def norm_kind(self) -> str:
        return "ln" if self.cfg.family == "encdec" else "rms"

    # ----- construction -----------------------------------------------------
    def _attn_mlp_layer_params(self, b: ParamBuilder, kind: str) -> Params:
        cfg = self.cfg
        if cfg.family == "moe":
            ffn = moe_lib.init_moe(b, cfg)
        else:
            ffn = init_mlp(b, cfg.d_model, cfg.d_ff, cfg.mlp_type)
        return {"ln1": _init_norm(b, cfg.d_model, kind),
                "attn": attn_lib.init_attention(b, cfg),
                "ln2": _init_norm(b, cfg.d_model, kind), "mlp": ffn}

    def _hybrid_layer_params(self, b: ParamBuilder, kind: str) -> Params:
        cfg = self.cfg
        init = {"rec": rglru_lib.init_rglru_block,
                "mamba": ssm_lib.init_mamba2}.get(kind,
                                                  attn_lib.init_attention)
        block = init(b, cfg)
        return {"ln1": _init_norm(b, cfg.d_model, "rms"), "block": block,
                "ln2": _init_norm(b, cfg.d_model, "rms"),
                "mlp": init_mlp(b, cfg.d_model, cfg.d_ff, cfg.mlp_type)}

    def init(self, seed: int = 0) -> Params:
        """Random parameters from ``seed`` (float32 master weights, the
        reference's initializers and shapes; not its random draws)."""
        return self._build(ParamBuilder(seed, self.device))

    def param_axes(self):
        """The logical-axes tree of :meth:`init`'s parameters, in the same
        layout (per-layer lists, the reference's stacked ``"layers"`` entry
        dropped), built without allocating a tensor."""
        if self._paxes is None:
            self._paxes = self._build(AxesBuilder())
        return self._paxes

    def param_shapes(self) -> Params:
        """:meth:`init`'s parameters without values: ``torch.empty`` of
        each shape and dtype on the model's device, fake under a
        ``FakeTensorMode`` (the dry-run's twin of ``jax.eval_shape(
        model.init)``)."""
        return self._build(ShapeBuilder(self.device))

    def _build(self, b) -> Params:
        cfg = self.cfg
        params: Params = {
            # Vocab padded to a multiple of 256; logits above vocab_size are
            # masked to -1e30 where they surface.
            "embed": b.param((cfg.padded_vocab, cfg.d_model),
                             ("vocab", "embed"), scale=0.02)}
        if not cfg.tie_embeddings:
            params["head"] = b.param((cfg.d_model, cfg.padded_vocab),
                                     ("embed", "vocab"), scale=0.02)
        params["final_norm"] = _init_norm(b, cfg.d_model, self.norm_kind)
        fam = cfg.family
        if fam in ("dense", "vlm", "moe"):
            params["layers"] = [self._attn_mlp_layer_params(b, "rms")
                                for _ in range(cfg.n_layers)]
        elif fam == "ssm":
            params["layers"] = [
                {"ln": _init_norm(b, cfg.d_model, "rms"),
                 "mixer": ssm_lib.init_mamba2(b, cfg)}
                for _ in range(cfg.n_layers)]
        elif fam == "hybrid":
            pattern = cfg.block_pattern
            n_units, rem = divmod(cfg.n_layers, len(pattern))
            params["layers"] = [
                tuple(self._hybrid_layer_params(b, kind) for kind in pattern)
                for _ in range(n_units)]
            if rem:  # omitted when empty, as in the reference
                params["rem_layers"] = tuple(
                    self._hybrid_layer_params(b, pattern[i])
                    for i in range(rem))
        else:  # encdec
            params["enc_layers"] = [self._attn_mlp_layer_params(b, "ln")
                                    for _ in range(cfg.n_enc_layers)]
            params["enc_norm"] = _init_norm(b, cfg.d_model, "ln")
            params["layers"] = [
                {"ln1": _init_norm(b, cfg.d_model, "ln"),
                 "self": attn_lib.init_attention(b, cfg),
                 "ln2": _init_norm(b, cfg.d_model, "ln"),
                 "cross": attn_lib.init_attention(b, cfg),
                 "ln3": _init_norm(b, cfg.d_model, "ln"),
                 "mlp": init_mlp(b, cfg.d_model, cfg.d_ff, cfg.mlp_type)}
                for _ in range(cfg.n_layers)]
        return params

    # ----- head -------------------------------------------------------------
    def head_matrix(self, params: Params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["head"]

    def _mask_pad_logits(self, logits: torch.Tensor,
                         lo: int = 0) -> torch.Tensor:
        """Pads (global vocab index >= ``vocab_size``) to -1e30; ``logits``
        holds the columns from ``lo``."""
        v = self.cfg.vocab_size
        if lo == 0 and logits.shape[-1] == v:
            return logits
        pad = torch.arange(lo, lo + logits.shape[-1],
                           device=logits.device) >= v
        return torch.where(pad, -1e30, logits)

    def _vocab_share(self) -> partition.Share:
        """This rank's :class:`partition.Share` of the padded vocab."""
        return partition.shard_of("vocab", self.cfg.padded_vocab)

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x: [B, d] final hidden states -> [B, V] f32, pads masked; under
        a split of the vocab, this rank's columns [B, V / m]."""
        x = _norm(params["final_norm"], x[:, None], self.norm_kind,
                  self.cfg.norm_eps)[:, 0]
        head = self.head_matrix(params)
        share = partition.shard_of("vocab", head.shape[1], "logits")
        logits = partition.copy_to_model(x, share) @ partition.wshard(
            head, COMPUTE_DTYPE, ("embed", "vocab"), share)
        logits = partition.constrain(logits.float(), ("batch", "vocab"))
        if self.cfg.logits_scaling != 1.0:
            logits = logits / self.cfg.logits_scaling
        return self._mask_pad_logits(logits, share.lo)

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy tokens [B] of :meth:`prefill`'s or :meth:`decode_step`'s
        logits: ``torch.argmax`` over the whole vocab, across the ranks'
        columns where they are split (ties to the smallest index)."""
        return partition.argmax_sharded(logits, self._vocab_share())

    def whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole vocab's logits [B, V] from each rank's columns (an
        all-gather); ``logits`` itself without a split."""
        return partition.gather_model(logits, -1, self._vocab_share())

    # ----- forward (training) ---------------------------------------------
    def _attn_mlp_layer(self, p: Params, x: torch.Tensor, positions, *,
                        causal: bool = True, window=None, prefix: int = 0,
                        rope: bool = True):
        """One attention + MLP (or MoE) layer of the training forward:
        (x, the layer's MoE aux loss or None)."""
        cfg = self.cfg
        kind = self.norm_kind
        h = _norm(p["ln1"], x, kind, cfg.norm_eps)
        x = x + attn_lib.attention(p["attn"], h, cfg, positions=positions,
                                   causal=causal, window=window, rope=rope,
                                   bidirectional_prefix=prefix)
        h = _norm(p["ln2"], x, kind, cfg.norm_eps)
        if cfg.family == "moe":
            y, aux = moe_lib.moe_mlp(p["mlp"], h, cfg)
            return partition.constrain(x + y, ACT), aux
        x = x + mlp(p["mlp"], h, cfg.mlp_type)
        return partition.constrain(x, ACT), None

    def _ssm_layer(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        h = _norm(p["ln"], x, "rms", self.cfg.norm_eps)
        x = x + ssm_lib.mamba2_block(p["mixer"], h, self.cfg)
        return partition.constrain(x, ACT)

    def _hybrid_train_layer(self, p: Params, x: torch.Tensor, positions,
                            kind: str) -> torch.Tensor:
        cfg = self.cfg
        h = _norm(p["ln1"], x, "rms", cfg.norm_eps)
        if kind == "rec":
            out = rglru_lib.recurrent_block(p["block"], h, cfg)
        elif kind == "mamba":
            out = ssm_lib.mamba2_block(p["block"], h, cfg)
        else:
            out = attn_lib.attention(p["block"], h, cfg, positions=positions,
                                     causal=True, window=cfg.local_window)
        x = _residual(x, out, cfg)
        h = _norm(p["ln2"], x, "rms", cfg.norm_eps)
        x = _residual(x, mlp(p["mlp"], h, cfg.mlp_type), cfg)
        return partition.constrain(x, ACT)

    def _hybrid_layers(self, params: Params):
        """(layer params, kind) of every hybrid layer in order: the pattern
        units' layers, then the remainder's."""
        flat = [p for unit in params["layers"] for p in unit]
        flat += params.get("rem_layers", ())
        return list(zip(flat, self.cfg.block_types()))

    def _decoder_layer(self, p: Params, x: torch.Tensor, positions,
                       enc: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = _norm(p["ln1"], x, "ln", cfg.norm_eps)
        x = x + attn_lib.attention(p["self"], h, cfg, positions=positions,
                                   causal=True)
        h = _norm(p["ln2"], x, "ln", cfg.norm_eps)
        x = x + attn_lib.attention(p["cross"], h, cfg, kv_x=enc, rope=False)
        h = _norm(p["ln3"], x, "ln", cfg.norm_eps)
        x = x + mlp(p["mlp"], h, cfg.mlp_type)
        return partition.constrain(x, ACT)

    def forward(self, params: Params, batch: Dict[str, torch.Tensor], *,
                remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training forward: (pre-head hidden states [B, S, d] after the
        final norm, the MoE aux loss summed over layers, 0 for the other
        families).  ``batch`` holds ``tokens`` [B, S] (tensors or arrays),
        plus ``patch_embeds`` (vlm) or ``frames`` (encdec).  With ``remat``
        each layer (encdec: each encoder and decoder layer) is recomputed
        in the backward instead of keeping its activations, as the
        reference's ``jax.checkpoint`` does."""
        cfg = self.cfg
        fam = cfg.family
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, S = tokens.shape
        x = embed_lookup(params["embed"], tokens, cfg.embedding_multiplier)
        if fam == "vlm":
            pe = torch.as_tensor(batch["patch_embeds"], device=self.device)
            x = torch.cat([pe.to(x.dtype), x[:, cfg.n_patches:]], dim=1)
        positions = torch.arange(S, device=self.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=self.device)

        def run(fn, *args, **kw):
            if remat:
                return checkpoint(fn, *args, use_reentrant=False,
                                  context_fn=partition.recompute_context,
                                  **kw)
            return fn(*args, **kw)

        if fam in ("dense", "vlm", "moe"):
            prefix = cfg.n_patches if fam == "vlm" else 0

            def layer(p, x):
                return self._attn_mlp_layer(p, x, positions,
                                            window=cfg.sliding_window,
                                            prefix=prefix)

            for i, p in enumerate(params["layers"]):
                x, a = run(_layer, layer, i, p, x)
                if a is not None:
                    aux = aux + a
        elif fam == "ssm":
            for i, p in enumerate(params["layers"]):
                x = run(_layer, self._ssm_layer, i, p, x)
        elif fam == "hybrid":
            for i, (p, kind) in enumerate(self._hybrid_layers(params)):
                x = run(_layer, self._hybrid_train_layer, i, p, x, positions,
                        kind, kind=kind)
        else:  # encdec
            enc = self._encode(params, torch.as_tensor(batch["frames"],
                                                       device=self.device),
                               remat=remat)
            for i, p in enumerate(params["layers"]):
                x = run(_layer, self._decoder_layer, i, p, x, positions, enc)
        x = _norm(params["final_norm"], x, self.norm_kind, cfg.norm_eps)
        return x, aux

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor], *,
                remat: bool = True) -> Tuple[torch.Tensor, dict]:
        """Mean next-token CE over ``batch["labels"]`` (and ``mask`` where
        given; the vlm family's image positions are masked out) plus
        ``1e-2 * aux`` for moe: (loss, {"ce", "aux"})."""
        cfg = self.cfg
        x, aux = self.forward(params, batch, remat=remat)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        mask = batch.get("mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
        if cfg.family == "vlm":
            pmask = (torch.arange(labels.shape[1], device=self.device)
                     >= cfg.n_patches)[None, :]
            mask = pmask if mask is None else mask * pmask
        ce = chunked_cross_entropy(x, self.head_matrix(params), labels, mask,
                                   valid_vocab=cfg.vocab_size,
                                   logits_scaling=cfg.logits_scaling)
        return ce + 1e-2 * aux, {"ce": ce, "aux": aux}

    # ----- decode cache -----------------------------------------------------
    def cache_window(self, max_seq: int) -> int:
        if self.cfg.sliding_window:
            return min(max_seq, self.cfg.sliding_window)
        return max_seq

    def attn_window(self, max_seq: int) -> int:
        """The positions a hybrid attention layer's cache holds: its
        ``local_window``'s, or every position where it has none."""
        if self.cfg.local_window:
            return min(max_seq, self.cfg.local_window)
        return max_seq

    @staticmethod
    def cache_bytes(cache) -> Tuple[int, int]:
        """(bytes of the cache's keys and values, bytes of its recurrent
        state: conv histories, SSM and RG-LRU states) on this rank."""
        kv = state = 0
        for path, t in torch.utils._pytree.tree_flatten_with_path(cache)[0]:
            n = t.numel() * t.element_size()
            if getattr(path[-1], "key", None) in ("k", "v", "xk", "xv"):
                kv += n
            else:
                state += n
        return kv, state

    def init_cache(self, batch: int, max_seq: int):
        """Zeroed decode cache in the reference's layout."""
        cfg = self.cfg
        fam = cfg.family
        dev = self.device

        def kv(n_layers, window):
            return attn_lib.init_decode_cache(cfg, n_layers, batch, window,
                                              device=dev)[0]

        if fam in ("dense", "vlm", "moe"):
            k, v = kv(cfg.n_layers, self.cache_window(max_seq))
            return {"k": k, "v": v}
        if fam == "ssm":
            conv, ssm = ssm_lib.init_mamba2_state(cfg, batch, dev)
            L = cfg.n_layers
            return {"conv": conv.expand((L,) + conv.shape).clone(),
                    "ssm": ssm.expand((L,) + ssm.shape).clone()}
        if fam == "hybrid":
            pattern = cfg.block_pattern
            n_units, rem = divmod(cfg.n_layers, len(pattern))

            def state(kind, n):
                if kind == "attn":
                    k, v = kv(n, self.attn_window(max_seq))
                    return {"k": k, "v": v}
                names, init = {
                    "rec": (("conv", "h"), rglru_lib.init_rglru_state),
                    "mamba": (("conv", "ssm"), ssm_lib.init_mamba2_state),
                }[kind]
                return {name: t.expand((n,) + t.shape).clone()
                        for name, t in zip(names, init(cfg, batch, dev))}

            return {"units": tuple(state(kind, n_units) for kind in pattern),
                    "rem": tuple({name: t[0] for name, t in
                                  state(pattern[i], 1).items()}
                                 for i in range(rem))}
        # encdec
        k, v = kv(cfg.n_layers, max_seq)
        xshape = (cfg.n_layers, batch, cfg.n_frames, cfg.n_kv_heads,
                  cfg.head_dim_)
        return {"k": k, "v": v,
                "xk": torch.zeros(xshape, dtype=COMPUTE_DTYPE, device=dev),
                "xv": torch.zeros(xshape, dtype=COMPUTE_DTYPE, device=dev)}

    # ----- layers -----------------------------------------------------------
    def _ffn(self, p: Params, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.family == "moe":
            return moe_lib.moe_mlp(p, h, self.cfg)[0]
        return mlp(p, h, self.cfg.mlp_type)

    def _hybrid_layer(self, p: Params, x, positions, kind: str, max_seq: int):
        """One hybrid layer at prefill: (x, its decode state)."""
        cfg = self.cfg
        h = _norm(p["ln1"], x, "rms", cfg.norm_eps)
        if kind == "rec":
            out, (conv, hst) = rglru_lib.recurrent_block(
                p["block"], h, cfg, return_state=True)
            st = {"conv": conv, "h": hst}
        elif kind == "mamba":
            out, (conv, ssm) = ssm_lib.mamba2_block(p["block"], h, cfg,
                                                    return_state=True)
            st = {"conv": conv, "ssm": ssm}
        else:
            out, (k, v) = attn_lib.attention_with_kv(
                p["block"], h, cfg, positions=positions,
                window=cfg.local_window)
            k, v = attn_lib.pack_cache(k, v, self.attn_window(max_seq))
            st = {"k": k, "v": v}
        x = _residual(x, out, cfg)
        h = _norm(p["ln2"], x, "rms", cfg.norm_eps)
        x = _residual(x, mlp(p["mlp"], h, cfg.mlp_type), cfg)
        return partition.constrain(x, ACT), st

    def _hybrid_decode(self, p: Params, x, kind: str, st: dict, pos: int):
        """One hybrid layer at decode; ``st`` is updated in place."""
        cfg = self.cfg
        h = _norm(p["ln1"], x[:, None], "rms", cfg.norm_eps)[:, 0]
        if kind == "rec":
            out, (conv, hst) = rglru_lib.recurrent_block_decode(
                p["block"], h, cfg, (st["conv"], st["h"]))
            st["conv"].copy_(conv)
            st["h"].copy_(hst)
        elif kind == "mamba":
            out, (conv, ssm) = ssm_lib.mamba2_decode(
                p["block"], h, cfg, (st["conv"], st["ssm"]))
            st["conv"].copy_(conv)
            st["ssm"].copy_(ssm)
        else:
            out, _, _ = attn_lib.decode_attn(
                p["block"], h, cfg, st["k"], st["v"], pos,
                attn_lib.global_window(st["k"].shape[1]))
        x = _residual(x, out, cfg)
        h = _norm(p["ln2"], x[:, None], "rms", cfg.norm_eps)
        return _residual(x, mlp(p["mlp"], h, cfg.mlp_type)[:, 0], cfg)

    def _encode(self, params: Params, frames: torch.Tensor, *,
                remat: bool = False) -> torch.Tensor:
        """Whisper's encoder over precomputed frame embeddings [B, F, d]
        (the conv frontend is a stub in the reference too): sinusoidal
        positions, non-causal attention without rope, layernorm; with
        ``remat`` each layer is recomputed in the backward."""
        cfg = self.cfg
        F = frames.shape[1]
        pos = torch.from_numpy(sinusoidal_positions(F, cfg.d_model)).to(
            self.device)
        x = frames.to(COMPUTE_DTYPE) + pos.to(COMPUTE_DTYPE)
        x = partition.constrain(x, ACT)

        def layer(p, x):
            return self._attn_mlp_layer(p, x, None, causal=False,
                                        rope=False)[0]

        for i, p in enumerate(params["enc_layers"]):
            x = (checkpoint(_layer, layer, i, p, x, encoder=True,
                            use_reentrant=False,
                            context_fn=partition.recompute_context)
                 if remat else _layer(layer, i, p, x, encoder=True))
        return _norm(params["enc_norm"], x, "ln", cfg.norm_eps)

    # ----- prefill ----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_seq: int) -> Tuple[torch.Tensor, dict]:
        """Process a prompt ``batch["tokens"]`` [B, S] (plus
        ``batch["patch_embeds"]`` [B, n_patches, d] for vlm, which overwrite
        the first positions, and ``batch["frames"]`` [B, n_frames, d] for
        encdec); returns (last-token logits [B, V] f32, this rank's
        columns under a split of the vocab; decode cache)."""
        cfg = self.cfg
        fam = cfg.family
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, S = tokens.shape
        x = embed_lookup(params["embed"], tokens, cfg.embedding_multiplier)
        if fam == "vlm":
            pe = torch.as_tensor(batch["patch_embeds"], device=self.device)
            x = torch.cat([pe.to(x.dtype), x[:, cfg.n_patches:]], dim=1)
        positions = torch.arange(S, device=self.device)[None, :]
        cache = self.init_cache(B, max_seq)
        if fam in ("dense", "vlm", "moe"):
            W = self.cache_window(max_seq)
            prefix = cfg.n_patches if fam == "vlm" else 0

            def layer(p, x):
                h = _norm(p["ln1"], x, "rms", cfg.norm_eps)
                out, (k, v) = attn_lib.attention_with_kv(
                    p["attn"], h, cfg, positions=positions,
                    window=cfg.sliding_window, bidirectional_prefix=prefix)
                x = x + out
                h = _norm(p["ln2"], x, "rms", cfg.norm_eps)
                x = partition.constrain(x + self._ffn(p["mlp"], h), ACT)
                return x, attn_lib.pack_cache(k, v, W)

            for i, p in enumerate(params["layers"]):
                x, (kc, vc) = _layer(layer, i, p, x)
                cache["k"][i].copy_(kc)
                cache["v"][i].copy_(vc)
        elif fam == "ssm":
            def layer(p, x):
                h = _norm(p["ln"], x, "rms", cfg.norm_eps)
                out, state = ssm_lib.mamba2_block(p["mixer"], h, cfg,
                                                  return_state=True)
                return partition.constrain(x + out, ACT), state

            for i, p in enumerate(params["layers"]):
                x, (conv, ssm) = _layer(layer, i, p, x)
                cache["conv"][i].copy_(conv)
                cache["ssm"][i].copy_(ssm)
        elif fam == "hybrid":
            pattern = cfg.block_pattern
            for u, unit in enumerate(params["layers"]):
                for i, kind in enumerate(pattern):
                    x, st = _layer(self._hybrid_layer, u * len(pattern) + i,
                                   unit[i], x, positions, kind, max_seq,
                                   kind=kind)
                    for name, t in st.items():
                        cache["units"][i][name][u].copy_(t)
            first = len(params["layers"]) * len(pattern)
            for i, p in enumerate(params.get("rem_layers", ())):
                x, st = _layer(self._hybrid_layer, first + i, p, x,
                               positions, pattern[i], max_seq,
                               kind=pattern[i])
                for name, t in st.items():
                    cache["rem"][i][name].copy_(t)
        else:  # encdec
            enc = self._encode(params, torch.as_tensor(batch["frames"],
                                                       device=self.device))

            def layer(p, x):
                h = _norm(p["ln1"], x, "ln", cfg.norm_eps)
                out, (k, v) = attn_lib.attention_with_kv(
                    p["self"], h, cfg, positions=positions)
                x = x + out
                h = _norm(p["ln2"], x, "ln", cfg.norm_eps)
                xk, xv = attn_lib.project_kv(p["cross"], enc, cfg)
                x = x + attn_lib.attention(p["cross"], h, cfg, kv_x=enc,
                                           rope=False)
                h = _norm(p["ln3"], x, "ln", cfg.norm_eps)
                x = x + mlp(p["mlp"], h, cfg.mlp_type)
                x = partition.constrain(x, ACT)
                kc, vc = attn_lib.pack_cache(k, v, max_seq)
                return x, (("k", kc), ("v", vc), ("xk", xk), ("xv", xv))

            for i, p in enumerate(params["layers"]):
                x, st = _layer(layer, i, p, x)
                for name, t in st:
                    cache[name][i].copy_(t)
        return self._logits(params, x[:, -1]), cache

    # ----- decode -----------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, params: Params, cache: dict, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, dict]:
        """One token.  token: [B] int; pos: the current length.  Returns
        (logits [B, V] f32, this rank's columns under a split of the
        vocab; the cache, updated in place)."""
        cfg = self.cfg
        fam = cfg.family
        token = torch.as_tensor(token, device=self.device)
        pos = int(pos)
        x = embed_lookup(params["embed"], token[:, None],
                         cfg.embedding_multiplier)[:, 0]           # [B, d]
        if fam in ("dense", "vlm", "moe"):
            W = attn_lib.global_window(cache["k"].shape[2])

            def layer(p, x, k, v):
                h = _norm(p["ln1"], x, "rms", cfg.norm_eps)
                out, _, _ = attn_lib.decode_attn(p["attn"], h, cfg, k, v,
                                                 pos, W)
                x = x + out
                h = _norm(p["ln2"], x[:, None], "rms", cfg.norm_eps)
                return x + self._ffn(p["mlp"], h)[:, 0]

            for i, p in enumerate(params["layers"]):
                x = _layer(layer, i, p, x, cache["k"][i], cache["v"][i])
        elif fam == "ssm":
            def layer(p, x, state):
                h = _norm(p["ln"], x, "rms", cfg.norm_eps)
                out, state = ssm_lib.mamba2_decode(p["mixer"], h, cfg, state)
                return x + out, state

            for i, p in enumerate(params["layers"]):
                x, (conv, ssm) = _layer(layer, i, p, x, (cache["conv"][i],
                                                         cache["ssm"][i]))
                cache["conv"][i].copy_(conv)
                cache["ssm"][i].copy_(ssm)
        elif fam == "hybrid":
            pattern = cfg.block_pattern
            for u, unit in enumerate(params["layers"]):
                for i, kind in enumerate(pattern):
                    st = {name: t[u] for name, t in
                          cache["units"][i].items()}
                    x = _layer(self._hybrid_decode, u * len(pattern) + i,
                               unit[i], x, kind, st, pos, kind=kind)
            first = len(params["layers"]) * len(pattern)
            for i, p in enumerate(params.get("rem_layers", ())):
                x = _layer(self._hybrid_decode, first + i, p, x, pattern[i],
                           cache["rem"][i], pos, kind=pattern[i])
        else:  # encdec
            W = attn_lib.global_window(cache["k"].shape[2])

            def layer(p, x, k, v, xk, xv):
                h = _norm(p["ln1"], x[:, None], "ln", cfg.norm_eps)[:, 0]
                out, _, _ = attn_lib.decode_attn(p["self"], h, cfg, k, v,
                                                 pos, W)
                x = x + out
                h = _norm(p["ln2"], x[:, None], "ln", cfg.norm_eps)[:, 0]
                x = x + attn_lib.decode_cross_attn(p["cross"], h, cfg, xk, xv)
                h = _norm(p["ln3"], x[:, None], "ln", cfg.norm_eps)
                return x + mlp(p["mlp"], h, cfg.mlp_type)[:, 0]

            for i, p in enumerate(params["layers"]):
                x = _layer(layer, i, p, x, *(cache[name][i] for name in
                                             ("k", "v", "xk", "xv")))
        return self._logits(params, x), cache

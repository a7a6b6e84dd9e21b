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

One table (``Model._table``) is the only code that knows a family's
layers: each entry gives a layer's parameters, its residual sublayers in
order, each as (norm key, sublayer, parameter key), and its span
attributes; the MLP or MoE feed-forward is chosen there once.  Each
sublayer (attention, cross-attention, Mamba-2, RG-LRU, feed-forward) is
written once for three modes: ``"forward"`` (its output and MoE aux loss),
``"prefill"`` (the same, its decode state copied into the layer's views of
the cache) and ``"decode"`` (one token, the state views read and updated
in place).  ``forward``, ``prefill`` and ``decode_step`` walk the same
table (``Model._walk``) and run each layer through ``Model._layer``.

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
are set: the embedding's multiplier, the residual multiplier of every
sublayer's output, the attention's scale and position embedding
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

import functools
import operator
from typing import Callable, Dict, NamedTuple, Optional, Tuple

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
    not 1 (in every family where it is set)."""
    if cfg.residual_multiplier != 1.0:
        y = y * cfg.residual_multiplier
    return x + y


def _write(st: dict, names, new) -> None:
    """Copy the tensors ``new`` into the cache views ``st[name]``."""
    for name, t in zip(names, new):
        st[name].copy_(t)


class _Sublayer(NamedTuple):
    """A residual sublayer: ``run(p, h, step, st)`` -> (output, MoE aux or
    None) on the normed stream ``h``, ``init(builder)`` -> its parameters."""
    run: Callable
    init: Callable


class _Layer(NamedTuple):
    """One entry of ``Model._table``."""
    path: tuple   # its parameters: params[path[0]][path[1]]...
    subs: tuple   # its residual sublayers: (norm key, _Sublayer, param key)
    attrs: dict   # the model.layer span's attributes
    first: int = 0  # the sublayer drawn first: init(seed)'s draw order


class _Table(NamedTuple):
    norm: str        # every norm's kind: "rms" or "ln"
    encoder: tuple   # whisper's encoder layers (none elsewhere)
    layers: tuple    # the layers on the token stream


class _Step(NamedTuple):
    """What the sublayers read beside their input."""
    mode: str                                 # forward, prefill, decode
    positions: Optional[torch.Tensor] = None  # [1, S] (forward, prefill)
    pos: int = 0                              # the decode position
    enc: Optional[torch.Tensor] = None        # the encoder's states


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
        return self._table.norm

    # ----- the layer table --------------------------------------------------
    @functools.cached_property
    def _table(self) -> _Table:
        """The layers in order, with their parameters, sublayers and spans."""
        cfg = self.cfg
        fam = cfg.family
        part = functools.partial
        ffn = (_Sublayer(lambda p, h, *_: moe_lib.moe_mlp(p, h, cfg),
                         part(moe_lib.init_moe, cfg=cfg)) if fam == "moe" else
               _Sublayer(lambda p, h, *_: (mlp(p, h, cfg.mlp_type), None),
                         part(init_mlp, d=cfg.d_model, ff=cfg.d_ff,
                              mlp_type=cfg.mlp_type)))
        init_attn = part(attn_lib.init_attention, cfg=cfg)

        def attn(**kw):
            return _Sublayer(part(self._attn, **kw), init_attn)

        mamba = _Sublayer(part(self._scan, ssm_lib.mamba2_block,
                               ssm_lib.mamba2_decode, ("conv", "ssm")),
                          part(ssm_lib.init_mamba2, cfg=cfg))
        L = range(cfg.n_layers)
        if fam == "ssm":
            return _Table("rms", (), tuple(
                _Layer(("layers", i), (("ln", mamba, "mixer"),), {"layer": i})
                for i in L))
        if fam == "hybrid":
            blocks = {"mamba": mamba, "attn": attn(window=cfg.local_window),
                      "rec": _Sublayer(part(
                          self._scan, rglru_lib.recurrent_block,
                          rglru_lib.recurrent_block_decode, ("conv", "h")),
                          part(rglru_lib.init_rglru_block, cfg=cfg))}
            n = len(cfg.block_pattern)
            whole = cfg.n_layers // n * n
            return _Table("rms", (), tuple(
                _Layer(("layers", i // n, i % n) if i < whole
                       else ("rem_layers", i % n),
                       (("ln1", blocks[kind], "block"), ("ln2", ffn, "mlp")),
                       {"layer": i, "kind": kind})
                for i, kind in enumerate(cfg.block_types())))
        if fam == "encdec":
            return _Table("ln", tuple(
                _Layer(("enc_layers", i),
                       (("ln1", attn(causal=False, rope=False), "attn"),
                        ("ln2", ffn, "mlp")),
                       {"layer": i, "encoder": True}, first=1)
                for i in range(cfg.n_enc_layers)), tuple(
                _Layer(("layers", i),
                       (("ln1", attn(), "self"),
                        ("ln2", _Sublayer(self._cross, init_attn), "cross"),
                        ("ln3", ffn, "mlp")), {"layer": i})
                for i in L))
        # dense, vlm, moe
        prefix = cfg.n_patches if fam == "vlm" else 0
        return _Table("rms", (), tuple(
            _Layer(("layers", i),
                   (("ln1", attn(window=cfg.sliding_window, prefix=prefix),
                     "attn"), ("ln2", ffn, "mlp")), {"layer": i}, first=1)
            for i in L))

    # ----- construction -----------------------------------------------------
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

    def _init_layer(self, b, layer: _Layer) -> Params:
        """A table entry's parameters: each sublayer's norm and block under
        its keys; the blocks draw from the builder from ``first`` on."""
        subs = layer.subs
        drawn = {key: sub.init(b)
                 for _, sub, key in subs[layer.first:] + subs[:layer.first]}
        out = {}
        for ln, _, key in subs:
            out[ln] = _init_norm(b, self.cfg.d_model, self.norm_kind)
            out[key] = drawn[key]
        return out

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
        if self._table.encoder:
            params["enc_layers"] = [self._init_layer(b, layer)
                                    for layer in self._table.encoder]
            params["enc_norm"] = _init_norm(b, cfg.d_model, self.norm_kind)
        layers = [self._init_layer(b, layer) for layer in self._table.layers]
        if cfg.family != "hybrid":
            params["layers"] = layers
            return params
        n = len(cfg.block_pattern)
        whole = cfg.n_layers // n * n
        params["layers"] = [tuple(layers[i:i + n]) for i in range(0, whole, n)]
        if whole < cfg.n_layers:  # omitted when empty, as in the reference
            params["rem_layers"] = tuple(layers[whole:])
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

    # ----- sublayers --------------------------------------------------------
    # Each takes its parameters, its normed input h, the _Step and the
    # layer's views of the cache ``st``, and gives (its output, the MoE aux
    # loss or None).  "forward" (training, and whisper's encoder everywhere)
    # reads no cache; "prefill" writes the layer's decode state into ``st``;
    # "decode" takes one token, h [B, 1, d], and reads and updates ``st``.
    def _attn(self, p: Params, h, step: _Step, st, *, window=None,
              prefix: int = 0, causal: bool = True, rope: bool = True):
        cfg = self.cfg
        if step.mode == "decode":
            out, _, _ = attn_lib.decode_attn(
                p, h[:, 0], cfg, st["k"], st["v"], step.pos,
                attn_lib.global_window(st["k"].shape[1]))
            return out[:, None], None
        if step.mode == "forward":
            return attn_lib.attention(
                p, h, cfg, positions=step.positions, causal=causal,
                window=window, rope=rope, bidirectional_prefix=prefix), None
        out, (k, v) = attn_lib.attention_with_kv(
            p, h, cfg, positions=step.positions, window=window,
            bidirectional_prefix=prefix)
        _write(st, ("k", "v"), attn_lib.pack_cache(
            k, v, attn_lib.global_window(st["k"].shape[1])))
        return out, None

    def _cross(self, p: Params, h, step: _Step, st):
        cfg = self.cfg
        if step.mode == "decode":
            return attn_lib.decode_cross_attn(p, h[:, 0], cfg, st["xk"],
                                              st["xv"])[:, None], None
        if step.mode == "prefill":
            _write(st, ("xk", "xv"), attn_lib.project_kv(p, step.enc, cfg))
        return attn_lib.attention(p, h, cfg, kv_x=step.enc, rope=False), None

    def _scan(self, block, decode, names, p: Params, h, step: _Step, st):
        """Mamba-2 or RG-LRU: ``block`` over the sequence, ``decode`` over
        one token; its state ``names`` in the cache."""
        cfg = self.cfg
        if step.mode == "forward":
            return block(p, h, cfg), None
        if step.mode == "prefill":
            out, new = block(p, h, cfg, return_state=True)
        else:
            out, new = decode(p, h[:, 0], cfg, tuple(st[n] for n in names))
            out = out[:, None]
        _write(st, names, new)
        return out, None

    # ----- the runner -------------------------------------------------------
    def _layer(self, layer: _Layer, p: Params, x: torch.Tensor, step: _Step,
               st) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One layer under its span: (x, its MoE aux loss or None)."""
        cfg = self.cfg
        kind = self.norm_kind
        aux = None
        with spans.span("model.layer", **layer.attrs):
            for ln, sub, key in layer.subs:
                y, a = sub.run(p[key], _norm(p[ln], x, kind, cfg.norm_eps),
                               step, st)
                x = _residual(x, y, cfg)
                del y  # not held while the next sublayer runs
                aux = a if a is not None else aux
            if step.mode != "decode":
                x = partition.constrain(x, ACT)
        return x, aux

    def _remat(self, *args):
        """:meth:`_layer` under its own ``checkpoint``: recomputed in the
        backward under the forward's ``partition`` rules."""
        return checkpoint(self._layer, *args, use_reentrant=False,
                          context_fn=partition.recompute_context)

    def _walk(self, params: Params, layers, cache=None):
        """Each entry of ``layers`` with its parameters and its views of
        ``cache`` (None without one).  The callers' loops rebind x, so a
        layer's input is freed when the layer returns."""
        for layer in layers:
            p = functools.reduce(operator.getitem, layer.path, params)
            st = (None if cache is None
                  else self._views(cache, layer.attrs["layer"]))
            yield layer, p, st

    def _inputs(self, params: Params, batch: Dict[str, torch.Tensor],
                mode: str, remat: bool = False) -> Tuple[torch.Tensor, _Step]:
        """The forward's and prefill's input: the token embeddings [B, S, d]
        (the vlm's ``patch_embeds`` over the first positions) and the
        :class:`_Step` (the positions; whisper's encoded ``frames``)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = embed_lookup(params["embed"], tokens, cfg.embedding_multiplier)
        if cfg.family == "vlm":
            pe = torch.as_tensor(batch["patch_embeds"], device=self.device)
            x = torch.cat([pe.to(x.dtype), x[:, cfg.n_patches:]], dim=1)
        positions = torch.arange(tokens.shape[1], device=self.device)[None, :]
        enc = (self._encode(params, torch.as_tensor(
            batch["frames"], device=self.device), remat=remat)
               if cfg.family == "encdec" else None)
        return x, _Step(mode, positions, enc=enc)

    def _encode(self, params: Params, frames: torch.Tensor, *,
                remat: bool = False) -> torch.Tensor:
        """Whisper's encoder over precomputed frame embeddings [B, F, d]
        (the conv frontend is a stub in the reference too): sinusoidal
        positions, non-causal attention without rope, layernorm; with
        ``remat`` each layer is recomputed in the backward."""
        cfg = self.cfg
        pos = torch.from_numpy(sinusoidal_positions(
            frames.shape[1], cfg.d_model)).to(self.device)
        x = frames.to(COMPUTE_DTYPE) + pos.to(COMPUTE_DTYPE)
        x = partition.constrain(x, ACT)
        run, step = (self._remat if remat else self._layer), _Step("forward")
        for layer, p, _ in self._walk(params, self._table.encoder):
            x, _ = run(layer, p, x, step, None)
        return _norm(params["enc_norm"], x, self.norm_kind, cfg.norm_eps)

    # ----- forward (training) ---------------------------------------------
    def forward(self, params: Params, batch: Dict[str, torch.Tensor], *,
                remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training forward: (pre-head hidden states [B, S, d] after the
        final norm, the MoE aux loss summed over layers, 0 for the other
        families).  ``batch`` holds ``tokens`` [B, S] (tensors or arrays),
        plus ``patch_embeds`` (vlm) or ``frames`` (encdec).  With ``remat``
        each layer (encdec: each encoder and decoder layer) is recomputed
        in the backward instead of keeping its activations, as the
        reference's ``jax.checkpoint`` does."""
        x, step = self._inputs(params, batch, "forward", remat)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        run = self._remat if remat else self._layer
        for layer, p, _ in self._walk(params, self._table.layers):
            x, a = run(layer, p, x, step, None)
            if a is not None:
                aux = aux + a
        return _norm(params["final_norm"], x, self.norm_kind,
                     self.cfg.norm_eps), aux

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
        dev = self.device

        def kv(n_layers, window):
            k, v = attn_lib.init_decode_cache(cfg, n_layers, batch, window,
                                              device=dev)[0]
            return {"k": k, "v": v}

        def state(kind, n):
            if kind == "attn":
                return kv(n, self.attn_window(max_seq))
            names, init = {
                "rec": (("conv", "h"), rglru_lib.init_rglru_state),
                "mamba": (("conv", "ssm"), ssm_lib.init_mamba2_state),
            }[kind]
            return {name: t.expand((n,) + t.shape).clone()
                    for name, t in zip(names, init(cfg, batch, dev))}

        if cfg.family == "ssm":
            return state("mamba", cfg.n_layers)
        if cfg.family == "hybrid":
            pattern = cfg.block_pattern
            n_units, rem = divmod(cfg.n_layers, len(pattern))
            return {"units": tuple(state(kind, n_units) for kind in pattern),
                    "rem": tuple({name: t[0] for name, t in
                                  state(pattern[i], 1).items()}
                                 for i in range(rem))}
        if cfg.family == "encdec":
            xshape = (cfg.n_layers, batch, cfg.n_frames, cfg.n_kv_heads,
                      cfg.head_dim_)
            return {**kv(cfg.n_layers, max_seq),
                    "xk": torch.zeros(xshape, dtype=COMPUTE_DTYPE, device=dev),
                    "xv": torch.zeros(xshape, dtype=COMPUTE_DTYPE, device=dev)}
        return kv(cfg.n_layers, self.cache_window(max_seq))

    def _views(self, cache: dict, i: int) -> dict:
        """Layer ``i``'s decode state: its views of ``cache``, by name."""
        cfg = self.cfg
        if cfg.family != "hybrid":
            return {name: t[i] for name, t in cache.items()}
        u, j = divmod(i, len(cfg.block_pattern))
        if u == cfg.n_layers // len(cfg.block_pattern):
            return cache["rem"][j]
        return {name: t[u] for name, t in cache["units"][j].items()}

    # ----- prefill and decode -----------------------------------------------
    @torch.no_grad()
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_seq: int) -> Tuple[torch.Tensor, dict]:
        """Process a prompt ``batch["tokens"]`` [B, S] (plus
        ``batch["patch_embeds"]`` [B, n_patches, d] for vlm, which overwrite
        the first positions, and ``batch["frames"]`` [B, n_frames, d] for
        encdec); returns (last-token logits [B, V] f32, this rank's
        columns under a split of the vocab; decode cache)."""
        x, step = self._inputs(params, batch, "prefill")
        cache = self.init_cache(x.shape[0], max_seq)
        for layer, p, st in self._walk(params, self._table.layers, cache):
            x, _ = self._layer(layer, p, x, step, st)
        return self._logits(params, x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, params: Params, cache: dict, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, dict]:
        """One token.  token: [B] int; pos: the current length.  Returns
        (logits [B, V] f32, this rank's columns under a split of the
        vocab; the cache, updated in place)."""
        token = torch.as_tensor(token, device=self.device)
        x = embed_lookup(params["embed"], token[:, None],
                         self.cfg.embedding_multiplier)          # [B, 1, d]
        step = _Step("decode", pos=int(pos))
        for layer, p, st in self._walk(params, self._table.layers, cache):
            x, _ = self._layer(layer, p, x, step, st)
        return self._logits(params, x[:, 0]), cache

"""The model's serving path for the ``dense`` and ``ssm`` families.

Port of the JAX package's ``models/model.py`` (``Model``: ``init``,
``init_cache``, ``prefill``, ``decode_step``, ``head_matrix``,
``_mask_pad_logits``, ``cache_window``).  Parameters are a plain dict
under the reference's key names, with ``params["layers"]`` a list of
per-layer dicts (the reference stacks them ``[L, ...]`` for ``lax.scan``;
here a Python loop runs the layers).  The decode cache keeps the
reference's stacked layout (``{"k", "v"}`` ``[L, B, W, KV, dh]`` or
``{"conv", "ssm"}``) and ``decode_step`` updates it in place.

The other families (moe, hybrid, encdec, vlm) and the training entry
points (``forward``, ``loss_fn``) are not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, ParamBuilder, Params,
                                       embed_lookup, init_mlp, mlp, rms_norm)

FAMILIES = ("dense", "ssm")


def _init_norm(b: ParamBuilder, d: int) -> Params:
    return {"scale": b.param((d,), init="zeros")}


class Model:
    """One model of the ``dense`` or ``ssm`` family on one device.

    ``device=None`` is the CUDA card and raises without one
    (``kernels/ops.py::resolve_device``); pass ``device="cpu"`` to run the
    plain torch versions on the host."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP.md "
                f"Queue 1, 'Model stack': moe, hybrid, encdec, vlm); the port "
                f"serves {FAMILIES}")
        self.cfg = cfg
        self.device = resolve_device(device)

    # ----- construction -----------------------------------------------------
    def init(self, seed: int = 0) -> Params:
        """Random parameters from ``seed`` (float32 master weights, the
        reference's initializers and shapes; not its random draws)."""
        cfg = self.cfg
        b = ParamBuilder(seed, self.device)
        params: Params = {
            # Vocab padded to a multiple of 256; logits above vocab_size are
            # masked to -1e30 where they surface.
            "embed": b.param((cfg.padded_vocab, cfg.d_model), scale=0.02)}
        if not cfg.tie_embeddings:
            params["head"] = b.param((cfg.d_model, cfg.padded_vocab),
                                     scale=0.02)
        params["final_norm"] = _init_norm(b, cfg.d_model)
        if cfg.family == "dense":
            params["layers"] = [
                {"ln1": _init_norm(b, cfg.d_model),
                 "attn": attn_lib.init_attention(b, cfg),
                 "ln2": _init_norm(b, cfg.d_model),
                 "mlp": init_mlp(b, cfg.d_model, cfg.d_ff, cfg.mlp_type)}
                for _ in range(cfg.n_layers)]
        else:
            params["layers"] = [
                {"ln": _init_norm(b, cfg.d_model),
                 "mixer": ssm_lib.init_mamba2(b, cfg)}
                for _ in range(cfg.n_layers)]
        return params

    # ----- head -------------------------------------------------------------
    def head_matrix(self, params: Params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["head"]

    def _mask_pad_logits(self, logits: torch.Tensor) -> torch.Tensor:
        v = self.cfg.vocab_size
        if logits.shape[-1] == v:
            return logits
        pad = torch.arange(logits.shape[-1], device=logits.device) >= v
        return torch.where(pad, -1e30, logits)

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x: [B, d] final hidden states -> [B, V] f32, pads masked."""
        x = rms_norm(x[:, None], params["final_norm"]["scale"],
                     self.cfg.norm_eps)[:, 0]
        logits = x @ self.head_matrix(params).to(COMPUTE_DTYPE)
        return self._mask_pad_logits(logits.float())

    # ----- decode cache -----------------------------------------------------
    def cache_window(self, max_seq: int) -> int:
        if self.cfg.sliding_window:
            return min(max_seq, self.cfg.sliding_window)
        return max_seq

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        """Zeroed decode cache."""
        cfg = self.cfg
        if cfg.family == "dense":
            k, v = attn_lib.init_decode_cache(
                cfg, cfg.n_layers, batch, self.cache_window(max_seq),
                device=self.device)
            return {"k": k, "v": v}
        conv, ssm = ssm_lib.init_mamba2_state(cfg, batch, self.device)
        L = cfg.n_layers
        return {"conv": conv.expand((L,) + conv.shape).clone(),
                "ssm": ssm.expand((L,) + ssm.shape).clone()}

    # ----- prefill ----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_seq: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Process a prompt ``batch["tokens"]`` [B, S]; returns (last-token
        logits [B, V] f32, decode cache)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, S = tokens.shape
        x = embed_lookup(params["embed"], tokens)
        cache = self.init_cache(B, max_seq)
        if cfg.family == "dense":
            W = cache["k"].shape[2]
            positions = torch.arange(S, device=self.device)[None, :]
            for i, p in enumerate(params["layers"]):
                h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
                out, (k, v) = attn_lib.attention_with_kv(
                    p["attn"], h, cfg, positions=positions,
                    window=cfg.sliding_window)
                x = x + out
                h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
                x = x + mlp(p["mlp"], h, cfg.mlp_type)
                kc, vc = attn_lib.pack_cache(k, v, W)
                cache["k"][i].copy_(kc)
                cache["v"][i].copy_(vc)
        else:
            for i, p in enumerate(params["layers"]):
                h = rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
                out, (conv, ssm) = ssm_lib.mamba2_block(p["mixer"], h, cfg,
                                                       return_state=True)
                x = x + out
                cache["conv"][i].copy_(conv)
                cache["ssm"][i].copy_(ssm)
        return self._logits(params, x[:, -1]), cache

    # ----- decode -----------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, params: Params, cache: Dict[str, torch.Tensor],
                    token: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One token.  token: [B] int; pos: the current length.  Returns
        (logits [B, V] f32, the cache, updated in place)."""
        cfg = self.cfg
        token = torch.as_tensor(token, device=self.device)
        pos = int(pos)
        x = embed_lookup(params["embed"], token)                   # [B, d]
        if cfg.family == "dense":
            W = cache["k"].shape[2]
            for i, p in enumerate(params["layers"]):
                h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
                out, _, _ = attn_lib.decode_attn(p["attn"], h, cfg,
                                                 cache["k"][i], cache["v"][i],
                                                 pos, W)
                x = x + out
                h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
                x = x + mlp(p["mlp"], h, cfg.mlp_type)
        else:
            for i, p in enumerate(params["layers"]):
                h = rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
                out, (conv, ssm) = ssm_lib.mamba2_decode(
                    p["mixer"], h, cfg, (cache["conv"][i], cache["ssm"][i]))
                x = x + out
                cache["conv"][i].copy_(conv)
                cache["ssm"][i].copy_(ssm)
        return self._logits(params, x), cache

"""Serving launcher: a static batch, prefilled once and decoded greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        --preset smoke --requests 4 --gen 16 --device cpu

Port of the JAX package's ``launch/serve.py`` on one card: the prompts are
left-padded to one length (the pads are not masked, as there), one prefill
builds the decode cache, and ``Model.decode_step`` runs once per new token
for the whole batch.  As there, a vlm prompt gets zero patch embeddings
and an encdec prompt zero audio frames (both frontends are stubs).  Weights are random, drawn from ``--seed``.  Without
``--device`` it runs on the CUDA card and raises without one.

Under ``torchrun --nproc-per-node N`` with N > 1, ``main`` binds, as the
reference does, a ``("data", "model")`` mesh of every rank on the model
axis with ``partition.fsdp_rules``: each rank holds and computes its share
of the heads, ff columns, experts, inner channels and vocab (a block whose
dim N does not divide gathers its weights and repeats), the greedy tokens
are the argmax across the ranks' vocab columns, the decode cache is
sharded on its positions (flash-decode, the cache length rounded up to a
multiple of N), and rank 0 prints.  Alone it serves plain tensors with no mesh: a one-rank mesh gives
the same tokens and costs the ``DTensor`` layer's host time.

Under a ``torch.profiler``, :meth:`Server.run` records its spans
(``repro_torch.spans``): ``serve.run`` {``rids``, ``first_token_ns``: each
request's host time, on ``time.perf_counter_ns``, at which its first token
reached ``Request.out``} around ``serve.submit`` (left-pad and copy to the
device), ``serve.prefill`` {``positions``: B x the padded length,
``prompt_tokens``; ``kv_bytes`` and ``state_bytes``, the decode cache's
bytes of keys and values and of recurrent state (``Model.cache_bytes``)}
and one ``serve.decode_step`` {``t``, ``active``: the
requests still decoding} a new token, which holds ``serve.host_sync`` (the
tokens' copy to the host, where the host waits for the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List

import numpy as np
import torch

from repro_torch import partition, spans
from repro_torch.configs import registry
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.mesh import make_host_mesh, process_group
from repro_torch.launch.train import preset_config
from repro_torch.models.layers import serving_copy
from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S0] int
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def prompt_batch(cfg, tokens: torch.Tensor) -> dict:
    """The prefill batch of ``tokens`` [B, S]: zero ``patch_embeds`` [B,
    n_patches, d] for the vlm family and zero ``frames`` [B, n_frames, d]
    for encdec, bfloat16, as the JAX ``Server.run`` feeds them."""
    batch = {"tokens": tokens}
    B = tokens.shape[0]
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            (B, cfg.n_patches, cfg.d_model), dtype=torch.bfloat16,
            device=tokens.device)
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((B, cfg.n_frames, cfg.d_model),
                                      dtype=torch.bfloat16,
                                      device=tokens.device)
    return batch


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """Single-model batch server (greedy decoding) on one device.

    Keeps a serving copy of ``params`` (matrices in bfloat16, exact for the
    forward: :func:`repro_torch.models.layers.serving_copy`).  ``device``
    must be the model's."""

    def __init__(self, model: Model, params, batch_slots: int, max_seq: int,
                 device=None):
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"server on {self.device}, model on "
                             f"{model.device}")
        self.model = model
        self.params = serving_copy(params)
        self.slots = batch_slots
        self.max_seq = max_seq

    def run(self, requests: List[Request]) -> dict:
        """Static batch: prefill all (left-padded to one length), decode
        until every request hits its token budget.  Times are host seconds
        that end in a device synchronize; ``logits_finite`` says whether
        every logit of the prefill and of each step was finite."""
        B = len(requests)
        if B > self.slots:
            raise ValueError(f"{B} requests for {self.slots} slots")
        with spans.span("serve.run") as traced:
            if traced is not None:
                traced.attrs.update(rids=[r.rid for r in requests],
                                    first_token_ns={})
            return self._run(requests, traced)

    def _run(self, requests: List[Request], traced) -> dict:
        model = self.model
        B = len(requests)
        s0 = max(len(r.prompt) for r in requests)
        with spans.span("serve.submit"):
            toks = np.zeros((B, s0), np.int64)
            for i, r in enumerate(requests):
                toks[i, s0 - len(r.prompt):] = r.prompt  # left-pad
            tokens = torch.from_numpy(toks).to(self.device)
        _sync(self.device)
        with spans.span("serve.prefill") as traced_prefill:
            if traced_prefill is not None:
                traced_prefill.attrs.update(
                    positions=B * s0,
                    prompt_tokens=sum(len(r.prompt) for r in requests))
            t0 = time.perf_counter()
            logits, cache = model.prefill(self.params,
                                          prompt_batch(model.cfg, tokens),
                                          max_seq=self.max_seq)
            nxt = model.greedy(logits)
            _sync(self.device)
            prefill_s = time.perf_counter() - t0
            if traced_prefill is not None:
                kv, state = model.cache_bytes(cache)
                traced_prefill.attrs.update(kv_bytes=kv, state_bytes=state)
        finite = torch.isfinite(logits).all()   # stays on the device

        max_new = max(r.max_new for r in requests)
        t0 = time.perf_counter()
        for t in range(max_new):
            with spans.span("serve.decode_step") as traced_step:
                if traced_step is not None:
                    traced_step.attrs.update(t=t, active=sum(
                        t < r.max_new for r in requests))
                with spans.span("serve.host_sync"):
                    host = nxt.tolist()  # one device -> host copy a step
                for i, r in enumerate(requests):
                    if t < r.max_new:
                        r.out.append(int(host[i]))
                        if t == 0 and traced is not None:
                            traced.attrs["first_token_ns"][r.rid] = \
                                time.perf_counter_ns()
                logits, cache = model.decode_step(self.params, cache, nxt,
                                                  s0 + t)
                nxt = model.greedy(logits)
                finite = finite & torch.isfinite(logits).all()
        _sync(self.device)
        decode_s = time.perf_counter() - t0
        for r in requests:
            r.done = True
        new_tokens = sum(len(r.out) for r in requests)
        return {"prefill_s": prefill_s, "decode_s": decode_s,
                "new_tokens": new_tokens,
                "tok_per_s": new_tokens / max(decode_s, 1e-9),
                "logits_finite": bool(finite)}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a batch of random prompts with random weights.")
    ap.add_argument("--arch", default="mamba2-370m",
                    choices=list(registry.ALL_ARCHS))
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain torch versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    with process_group(dev):
        return _serve(args, dev)


def _serve(args, dev):
    cfg = preset_config(args.arch, args.preset)
    model = Model(cfg, device=dev)
    world = torch.distributed.get_world_size()
    rules = None
    if world > 1:
        rules = partition.fsdp_rules(
            make_host_mesh(data=1, model=world, device=dev), args.requests)
    rng = np.random.default_rng(args.seed)
    max_seq = -(-(args.prompt_len + args.gen + 8) // world) * world
    with partition.use_rules(rules):
        params = model.init(args.seed)
        if rules is not None:
            params = partition.place(params, partition.param_shardings(
                rules, model.param_axes()))
        srv = Server(model, params, args.requests, max_seq=max_seq,
                     device=dev)
        del params
        reqs = [Request(rid=i,
                        prompt=rng.integers(1, cfg.vocab_size,
                                            args.prompt_len),
                        max_new=args.gen)
                for i in range(args.requests)]
        stats = srv.run(reqs)
    if torch.distributed.get_rank() == 0:
        print(json.dumps({"arch": cfg.name, "device": str(model.device),
                          "ranks": world,
                          **{k: (round(v, 4) if isinstance(v, float) else v)
                             for k, v in stats.items()}}))
    return stats


if __name__ == "__main__":
    main()

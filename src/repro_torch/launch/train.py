"""Training launcher: Model + AdamW + the train step + the fault-tolerant
loop + checkpoints, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
        --preset smoke --steps 20 --device cpu

Port of the JAX package's ``launch/train.py``.  ``--preset full`` uses the
assigned config verbatim; ``smoke`` reduces it to CPU scale; ``100m`` is a
~100M-parameter same-family config, and ``--preset 100m --steps 300
--batch 8 --seq 256 --lr 3e-3`` with checkpoints is the twin of
``examples/train_100m.py``.  Without ``--device`` it runs on the CUDA card
and raises without one; every family trains there (the ssm family's SSD
scan through its forward and backward kernels).

Under ``torchrun --nproc-per-node N`` with N > 1 (one rank a card, or gloo
ranks with ``--device cpu``), it binds, as the reference does, a
``("data", "model")`` mesh of every rank on the data axis with
``partition.fsdp_rules``: the state is sharded (FSDP), each rank trains on
its shard of the batch, and rank 0 prints.  Alone it trains plain tensors
with no mesh: a one-rank mesh gives the same step and costs the
``DTensor`` layer's host time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch import partition
from repro_torch.configs import registry
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.mesh import make_host_mesh, process_group
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.loop import LoopConfig, run_loop
from repro_torch.train.trainer import init_state, make_train_step


def preset_config(arch: str, preset: str):
    """``full`` is the assigned config verbatim, ``smoke`` its CPU-size
    reduction, ``100m`` a ~100M-parameter same-family config."""
    cfg = registry.get_config(arch)
    if preset == "full":
        return cfg
    if preset == "smoke":
        return cfg.reduced()
    if preset == "100m":
        return dataclasses.replace(
            cfg.reduced(), name=cfg.name + "-100m",
            n_layers=max(4, min(cfg.n_layers, 8)),
            d_model=512, n_heads=8, n_kv_heads=min(cfg.n_kv_heads, 4),
            head_dim=64, d_ff=1408 if not cfg.n_experts else 512,
            vocab_size=32_000,
            ssm_state=64 if cfg.ssm_state else 0,
            rnn_width=512 if cfg.rnn_width else None)
    raise ValueError(preset)


#: warmup steps of the launcher's schedule, as the reference's
WARMUP = 20


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m",
                    choices=list(registry.ALL_ARCHS))
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data", default="succ", choices=["succ", "copy", "zipf"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    with process_group(dev):
        out = _train(args, dev)
    return out


def _train(args, dev):
    cfg = preset_config(args.arch, args.preset)
    model = Model(cfg, device=dev)
    world = torch.distributed.get_world_size()
    rules = None
    if world > 1:
        rules = partition.fsdp_rules(
            make_host_mesh(data=world, model=1, device=dev), args.batch)
    opt = AdamW(learning_rate=cosine_schedule(args.lr, WARMUP, args.steps))
    data = SyntheticLMData.for_config(cfg, args.seq, args.batch,
                                      seed=args.seed, mode=args.data)

    def put_batch(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    with partition.use_rules(rules):
        state = init_state(model, opt, args.seed)
        step = make_train_step(model, opt, microbatches=args.microbatches,
                               compress_grads=args.compress_grads,
                               param_axes=model.param_axes())
        out = run_loop(step, state, data, LoopConfig(
            total_steps=args.steps,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
            metrics_path=args.metrics), put_batch=put_batch,
            log=print if torch.distributed.get_rank() == 0 else _quiet)
    losses = out["losses"]
    if torch.distributed.get_rank() == 0:
        print(json.dumps({
            "arch": cfg.name, "device": str(dev), "steps": out["final_step"],
            "ranks": world,
            "first_loss": losses[0] if losses else None,
            "last_loss": float(np.mean(losses[-5:])) if losses else None,
            "stragglers": out["stragglers"], "recoveries": out["recoveries"],
        }))
    return out


def _quiet(msg: str) -> None:
    pass


if __name__ == "__main__":
    main()

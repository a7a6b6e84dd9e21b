"""Fault-tolerant training loop: checkpoint/restart, failure recovery,
straggler watchdog.

Port of the JAX package's ``train/loop.py``:

* **Checkpoint/restart** — periodic async checkpoints; on (re)start the
  loop restores the latest complete checkpoint and resumes after its step;
  the data pipeline is keyed by step, so the replayed stream is exact.
* **Failure recovery** — an exception from the step function (device loss,
  preemption; simulated in tests through ``failure_hook``) triggers a
  restore of the latest checkpoint and a retry, up to ``max_recoveries``.
* **Straggler watchdog** — an EWMA of the step's wall time; steps slower
  than ``straggler_factor`` x EWMA are counted and surfaced.

Each metrics row carries the step's seconds (``time_s``) and the seconds
its batch took to arrive (``data_s``: ``data.batch`` and ``put_batch``,
the ``loop.data`` span of ``repro_torch.spans``), both on
``time.perf_counter``.

Unlike the reference, the step the loop resumes after is the one stored in
the checkpoint it restored (``CheckpointStore.restore`` returns it): the
reference reads ``latest_step()`` again after restoring, and an async save
that publishes in between makes it resume after a newer step than the
state it holds.  On a failure the loop also waits for a save in flight
before it restores, so it restores the newest checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, Optional

from repro_torch import spans
from repro_torch.checkpoint.store import CheckpointStore


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep: int = 3
    straggler_factor: float = 3.0
    max_recoveries: int = 5
    log_every: int = 10
    metrics_path: Optional[str] = None


def _restore(store: CheckpointStore, state, shardings):
    """``store.restore``: onto ``shardings`` where given, else onto the
    placements ``state`` has."""
    if shardings is None:
        return store.restore(state)
    return store.restore(state, shardings=shardings)


def run_loop(step_fn: Callable, state, data, cfg: LoopConfig, *,
             state_shardings=None,
             put_batch: Callable = None,
             failure_hook: Callable[[int], None] = None,
             log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Run ``state, metrics = step_fn(state, batch)`` for
    ``cfg.total_steps`` steps.

    ``data.batch(step)`` supplies batches, ``put_batch`` (if given) moves
    one to the device; ``failure_hook(step)`` may raise to simulate a node
    failure.  Checkpoints go to a :class:`CheckpointStore` over
    ``cfg.checkpoint_dir`` (none without one); ``state_shardings`` (a tree
    of ``partition.Sharding``s congruent with ``state``) places every
    restored leaf, for a restart on another mesh; without it a restore
    keeps ``state``'s own placements.  Returns the final state,
    the losses of every step run (replayed steps included), the step
    numbers they belong to, and the straggler and recovery counts."""
    store = (CheckpointStore(cfg.checkpoint_dir, cfg.keep)
             if cfg.checkpoint_dir else None)
    start = 0
    if store is not None and store.latest_step() is not None:
        state, restored = _restore(store, state, state_shardings)
        start = restored + 1
        log(f"[loop] restored checkpoint {restored}, resuming at step {start}")

    ewma = None
    stragglers = 0
    recoveries = 0
    losses, loss_steps = [], []
    metrics_f = open(cfg.metrics_path, "a") if cfg.metrics_path else None
    try:
        step = start
        while step < cfg.total_steps:
            try:
                if failure_hook is not None:
                    failure_hook(step)
                t0 = time.perf_counter()
                with spans.span("loop.data"):
                    batch = data.batch(step)
                    if put_batch is not None:
                        batch = put_batch(batch)
                t1 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t1
                if ewma is None:
                    ewma = dt
                elif dt > cfg.straggler_factor * ewma and step > start + 2:
                    stragglers += 1
                    log(f"[loop] step {step}: straggler ({dt:.2f}s vs "
                        f"EWMA {ewma:.2f}s)")
                ewma = 0.9 * ewma + 0.1 * dt if ewma else dt
                losses.append(loss)
                loss_steps.append(step)
                if metrics_f:
                    row = {"step": step, "loss": loss, "time_s": dt,
                           "data_s": t1 - t0}
                    row.update({k: float(v) for k, v in metrics.items()
                                if k != "loss"})
                    metrics_f.write(json.dumps(row) + "\n")
                    metrics_f.flush()
                if cfg.log_every and step % cfg.log_every == 0:
                    log(f"[loop] step {step}: loss={loss:.4f} ({dt:.2f}s)")
                if store is not None and cfg.checkpoint_every and \
                        step % cfg.checkpoint_every == 0 and step > start:
                    store.save(step, state)
                step += 1
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — node-failure surface
                recoveries += 1
                if recoveries > cfg.max_recoveries or store is None:
                    raise
                log(f"[loop] step {step}: FAILURE {type(e).__name__}: {e}; "
                    f"restoring latest checkpoint "
                    f"({recoveries}/{cfg.max_recoveries})")
                store.wait()   # a save in flight is the newest checkpoint
                if store.latest_step() is not None:
                    state, restored = _restore(store, state,
                                               state_shardings)
                    step = restored + 1
                else:
                    step = start  # nothing saved yet: restart from scratch

        if store is not None:
            store.save(step - 1, state, blocking=True)
    finally:
        if metrics_f:
            metrics_f.close()
    return {"state": state, "losses": losses, "loss_steps": loss_steps,
            "stragglers": stragglers, "recoveries": recoveries,
            "final_step": step}

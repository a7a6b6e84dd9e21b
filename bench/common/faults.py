"""Faults planted in the program under the timed path, for the tests and the
calibration that show the comparison catches them.  Each is a context
manager that patches the port while it is open; none is reachable from a
benchmark run.

* ``unchanged``: the train step returns the state unchanged (AdamW's update
  does nothing).
* ``half_batch``: the loss leaves out half of the batch's rows and takes the
  mean over the rest; a ``Server.run`` serves only the first half of its
  requests.
* ``altered_token``: the greedy pick returns another token than its argmax
  for some rows of some calls (every request gets some).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def unchanged():
    from repro_torch.optim.adamw import AdamW, OptState

    def update(self, grads, state, params):
        return params, OptState(state.m, state.v, state.count + 1), {}

    return _patched(AdamW, "update", update)


@contextlib.contextmanager
def half_batch():
    from repro_torch.launch.serve import Server
    from repro_torch.models.model import Model
    loss_fn, run = Model.loss_fn, Server.run

    def half_loss(self, params, batch, **kw):
        half = {k: v[:max(1, v.shape[0] // 2)] for k, v in batch.items()}
        return loss_fn(self, params, half, **kw)

    def half_run(self, requests):
        return run(self, requests[:max(1, len(requests) // 2)])

    with _patched(Model, "loss_fn", half_loss), \
            _patched(Server, "run", half_run):
        yield


def altered_token():
    from repro_torch.models.model import Model
    greedy = Model.greedy
    calls = [0]

    def altered(self, logits):
        tok = greedy(self, logits)
        rows = (calls[0] + torch.arange(tok.shape[0], device=tok.device)) % 7
        calls[0] += 1
        return torch.where(rows == 0, (tok + 1) % self.cfg.vocab_size, tok)

    return _patched(Model, "greedy", altered)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered_token": altered_token}
#: The faults each kind of cell can have.
KINDS = {"train": ("unchanged", "half_batch"),
         "serve": ("half_batch", "altered_token")}

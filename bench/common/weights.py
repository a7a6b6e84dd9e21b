"""Weights made by the benchmark from ``--seed``, handed alike to the program
and to the plain reference.

A family's reference module lists its parameters as ``(path, shape, init)``
(``bench/reference/<family>.py::param_specs``).  :func:`make` draws every
``normal`` leaf from one ``torch.randn`` call and every ``uniform`` leaf from
one ``torch.rand`` call on the device's own generator, so a danube state is a
handful of device calls, and lays the leaves out as views of those buffers in
the program's tree layout (nested dicts, ``layers`` a list).  The same seed
gives the same bits on the same device, so the reference rebuilds the weights
after the program's state is freed instead of keeping a copy.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import torch

#: Standard deviation of every ``normal`` leaf (the port's initializer scale).
NORMAL_SCALE = 0.02
#: Keeps the weight generator apart from the data generators of one seed.
WEIGHT_STREAM = 0


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``(seed, stream)``, hashed so that no two pairs
    share one in practice."""
    digest = hashlib.sha256(f"{int(seed)}:{int(stream)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for ``(seed, stream)``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream_seed(seed, stream))
    return g


def numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def make(specs: List[Tuple[tuple, tuple, str]], seed: int, device
         ) -> Tuple[dict, List[torch.Tensor]]:
    """(tree, leaves): float32 parameters of ``specs`` drawn from ``seed``.
    ``leaves`` is in ``specs`` order; each is a view of one of four
    buffers (normal, uniform, zeros, ones)."""
    device = torch.device(device)
    sizes: Dict[str, int] = {"normal": 0, "uniform": 0, "zeros": 0, "ones": 0}
    for _, shape, init in specs:
        if init not in sizes:
            raise ValueError(f"unknown init {init!r}")
        sizes[init] += numel(shape)
    g = generator(seed, WEIGHT_STREAM, device)
    kw = dict(dtype=torch.float32, device=device)
    bufs = {
        "normal": torch.randn(sizes["normal"], generator=g, **kw).mul_(
            NORMAL_SCALE),
        "uniform": torch.rand(sizes["uniform"], generator=g, **kw),
        "zeros": torch.zeros(sizes["zeros"], **kw),
        "ones": torch.ones(sizes["ones"], **kw),
    }
    offsets = dict.fromkeys(sizes, 0)
    leaves = []
    for _, shape, init in specs:
        n = numel(shape)
        leaves.append(bufs[init][offsets[init]:offsets[init] + n].view(shape))
        offsets[init] += n
    return tree_of([path for path, _, _ in specs], leaves), leaves


def tree_of(paths: List[tuple], leaves: List) -> dict:
    """The nested tree of ``leaves`` at ``paths``: a string key is a dict
    entry, an int key a list index (lists are filled in order)."""
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(key, int):
                while len(node) <= key:
                    node.append({} if isinstance(nxt, str) else [])
                node = node[key]
            else:
                if key not in node:
                    node[key] = {} if isinstance(nxt, str) else []
                node = node[key]
        node[path[-1]] = leaf
    return root


def at(tree, path: tuple):
    """The leaf of ``tree`` at ``path``."""
    for key in path:
        tree = tree[key]
    return tree


def leaf_norms(tree, paths: List[tuple], minus=None) -> torch.Tensor:
    """Float32 norms [len(paths)] of the leaves at ``paths`` (of ``leaf -
    minus``'s leaf where ``minus`` is a list of tensors in the same order),
    on the leaves' device."""
    out = []
    for i, path in enumerate(paths):
        t = at(tree, path).float()
        if minus is not None:
            t = t - minus[i]
        out.append(torch.linalg.vector_norm(t))
    return torch.stack(out)

"""AdamW's update and its gradient norm as one multi-tensor CUDA kernel.

``csrc/adamw.cu`` replaces no Pallas kernel: the JAX package's
``optim/adamw.py`` leaves the update to XLA.  On the card the per-leaf
loop of about 21 float32 passes (``update_plain``) moved ~190 bytes an
element; the kernel moves the least the work needs, 32: one pass reads
the gradients for the global norm, one reads g, p, m and v and writes p, m
and v.  Its design is in the source's header.

The leaves go to the kernel as one table (:func:`leaf_table`): each leaf's
g, p, m and v pointers and element count, then the prefix of its chunk
counts (:func:`chunk_table`, :data:`CHUNK` elements a chunk), which a block
searches for the leaf of a chunk (:func:`chunk_span` mirrors it).  The
table is built on the host for every call (autograd hands over fresh
gradients each step), in pinned memory taken fresh from torch's caching
host allocator, which keeps a block from reuse until the copy that reads it
has run, and goes to the card in one copy on the current stream.

Functions:

* :func:`sq_norms_plain`, :func:`update_plain` — the plain versions: the
  per-leaf loop of ``AdamW.update`` before the kernel, in its order (the
  CPU path);
* :func:`sq_norms_cuda`, :func:`update_cuda` — the kernel's wrappers, the
  ``torch.library`` ops ``repro_torch::adamw_sq_norms`` and
  ``repro_torch::adamw_update`` (mutating p, m and v), whose fake
  implementations launch nothing (a ``FakeTensorMode`` trace or ``meta``
  tensors); each counts its kernel launches in ``.launches``;
* :func:`contiguous_grads` — the gradients as the kernel takes them,
  counting the copies it makes in ``contiguous_grads.copies`` (none on the
  main path).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import build

#: Elements a chunk (``kChunk`` of ``csrc/adamw.cu``).
CHUNK = 1 << 15
#: int64 words a leaf takes in the table: g, p, m, v, numel.
LEAF_WORDS = 5


# ---------------------------------------------------------------------------
# The chunk table: a pure function of the leaves' sizes.
# ---------------------------------------------------------------------------


def chunk_table(sizes: Sequence[int], chunk: int = CHUNK) -> np.ndarray:
    """``[n + 1]`` int64: ``first[i]`` is leaf i's first chunk, ``first[n]``
    the number of chunks.  A leaf of ``s`` elements has ``ceil(s / chunk)``
    chunks, an empty one none."""
    counts = -(-np.asarray(sizes, dtype=np.int64) // chunk)
    first = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=first[1:])
    return first


def chunk_span(first: np.ndarray, sizes: Sequence[int], c: int,
               chunk: int = CHUNK) -> tuple:
    """(leaf, start, count) of chunk ``c``, as the kernel's ``leaf_of`` and
    ``chunk_count`` find them: the last leaf whose first chunk is at most
    ``c`` (binary search), the chunk's first element and its length."""
    lo, hi = 0, len(sizes) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= c:
            lo = mid
        else:
            hi = mid - 1
    start = (c - int(first[lo])) * chunk
    return lo, start, min(chunk, int(sizes[lo]) - start)


def leaf_table(g: Sequence[torch.Tensor],
               pmv: Optional[Sequence[Sequence[torch.Tensor]]] = None):
    """(device table, chunks): the kernel's int64 table of the leaves
    (``LEAF_WORDS`` words a leaf, p, m and v left unset without ``pmv``,
    then :func:`chunk_table` of their sizes) on g's device, copied from
    pinned memory on the current stream."""
    n = len(g)
    sizes = np.fromiter((t.numel() for t in g), np.int64, n)
    first = chunk_table(sizes)
    host = torch.empty(LEAF_WORDS * n + n + 1, dtype=torch.int64,
                       pin_memory=True)
    words = host.numpy()
    leaves = words[:LEAF_WORDS * n].reshape(n, LEAF_WORDS)
    for j, ts in enumerate([g, *(pmv or ())]):
        leaves[:, j] = np.fromiter((t.data_ptr() for t in ts), np.int64, n)
    leaves[:, 4] = sizes
    words[LEAF_WORDS * n:] = first
    return host.to(g[0].device, non_blocking=True), int(first[-1])


# ---------------------------------------------------------------------------
# The plain versions.
# ---------------------------------------------------------------------------


def sq_norms_plain(g: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each leaf's sum of squares in float32, one ``torch.sum`` a leaf."""
    return [torch.sum(torch.square(x.float())) for x in g]


def update_plain(g, p, m, v, scale, lr, bc1, bc2, *, b1: float, b2: float,
                 eps: float, wd: float) -> None:
    """AdamW's update of every leaf in place, a loop over the leaves in the
    reference's order: g*scale (no scaling where ``scale`` is None);
    m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g^2;
    step = (m/bc1) / (sqrt(v/bc2) + eps) + wd*p; p = p - lr*step."""
    for gi, mi, vi, pi in zip(g, m, v, p):
        gi = gi if scale is None else gi * scale
        gi = gi.float()
        mi.copy_(b1 * mi + (1 - b1) * gi)
        vi.copy_(b2 * vi + (1 - b2) * torch.square(gi))
        step = (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
        step = step + wd * pi.float()
        pi.copy_((pi.float() - lr * step).to(pi.dtype))


# ---------------------------------------------------------------------------
# The CUDA kernel, as operators of torch's dispatcher.
# ---------------------------------------------------------------------------


def _library():
    """The built kernel library with its C signatures declared."""
    lib = build.load("adamw")
    if not getattr(lib, "_adamw_typed", False):
        lib.adamw_chunk_elements.argtypes = []
        lib.adamw_chunk_elements.restype = ctypes.c_int64
        lib.adamw_sq_norms_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.adamw_sq_norms_launch.restype = ctypes.c_int
        lib.adamw_update_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
            *[ctypes.c_float] * 6, ctypes.c_void_p]
        lib.adamw_update_launch.restype = ctypes.c_int
        lib.adamw_error_string.argtypes = [ctypes.c_int]
        lib.adamw_error_string.restype = ctypes.c_char_p
        if lib.adamw_chunk_elements() != CHUNK:
            raise RuntimeError(
                f"csrc/adamw.cu chunks {lib.adamw_chunk_elements()} elements,"
                f" kernels/adamw.py {CHUNK}")
        lib._adamw_typed = True
    return lib


def _check(fn: str, **lists) -> None:
    """Every leaf a contiguous float32 tensor on one device, the lists of
    one length and each leaf's numel the same across them."""
    ref = lists["g"]
    if not ref:
        raise ValueError(f"{fn}: no leaves")
    device = ref[0].device
    for name, ts in lists.items():
        if len(ts) != len(ref):
            raise ValueError(f"{fn}: {len(ts)} {name} leaves, {len(ref)} g")
        for i, t in enumerate(ts):
            if (not isinstance(t, torch.Tensor) or t.device != device
                    or t.dtype != torch.float32 or not t.is_contiguous()
                    or t.numel() != ref[i].numel()):
                raise ValueError(
                    f"{fn}: {name}[{i}] must be a contiguous float32 tensor "
                    f"of {ref[i].numel()} elements on {device}; got "
                    f"{getattr(t, 'dtype', type(t).__name__)} "
                    f"{tuple(getattr(t, 'shape', ()))} on "
                    f"{getattr(t, 'device', None)}")


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"adamw {what} kernel launch failed: "
                           + lib.adamw_error_string(rc).decode())


def _sq_norms_launch(g):
    """``repro_torch::adamw_sq_norms`` on the card."""
    out = torch.empty(len(g), dtype=torch.float32, device=g[0].device)
    with torch.cuda.device(g[0].device):
        table, chunks = leaf_table(g)
        if chunks == 0:
            return out.zero_()
        lib = _library()
        partials = torch.empty(chunks, dtype=torch.float64,
                               device=g[0].device)
        stream = torch.cuda.current_stream(g[0].device).cuda_stream
        _raise(lib, lib.adamw_sq_norms_launch(
            table.data_ptr(), len(g), chunks, partials.data_ptr(),
            out.data_ptr(), stream), "norm")
    sq_norms_cuda.launches += 2
    return out


def _sq_norms_fake(g):
    return g[0].new_empty((len(g),), dtype=torch.float32)


def _update_launch(g, p, m, v, scalars, b1, b2, eps, wd):
    """``repro_torch::adamw_update`` on the card."""
    with torch.cuda.device(g[0].device):
        table, chunks = leaf_table(g, (p, m, v))
        if chunks == 0:
            return
        lib = _library()
        # The float32 values torch's scalar operands take: (1 - b1) is the
        # Python float rounded once, as in ``(1 - b1) * g``.
        consts = [float(np.float32(x)) for x in (b1, b2, 1 - b1, 1 - b2,
                                                 eps, wd)]
        stream = torch.cuda.current_stream(g[0].device).cuda_stream
        _raise(lib, lib.adamw_update_launch(
            table.data_ptr(), len(g), chunks, scalars.data_ptr(), *consts,
            stream), "update")
    update_cuda.launches += 1


def _update_fake(g, p, m, v, scalars, b1, b2, eps, wd):
    return None


LIBRARY = torch.library.Library("repro_torch", "FRAGMENT")
LIBRARY.define("adamw_sq_norms(Tensor[] g) -> Tensor")
LIBRARY.define("adamw_update(Tensor[] g, Tensor(a!)[] p, Tensor(b!)[] m, "
               "Tensor(c!)[] v, Tensor scalars, float b1, float b2, "
               "float eps, float wd) -> ()")
LIBRARY.impl("adamw_sq_norms", _sq_norms_launch, "CUDA")
LIBRARY.impl("adamw_update", _update_launch, "CUDA")
torch.library.register_fake("repro_torch::adamw_sq_norms", _sq_norms_fake,
                            lib=LIBRARY)
torch.library.register_fake("repro_torch::adamw_update", _update_fake,
                            lib=LIBRARY)


def sq_norms_cuda(g: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[len(g)]`` float32: each leaf's sum of squares (``csrc/adamw.cu``,
    two launches), still being computed on the current stream.  Takes
    contiguous float32 CUDA tensors; raises on any other input and if a
    launch is refused.  Fake or meta tensors launch nothing."""
    g = list(g)
    _check("sq_norms_cuda", g=g)
    return torch.ops.repro_torch.adamw_sq_norms.default(g)


sq_norms_cuda.launches = 0


def update_cuda(g, p, m, v, scalars: torch.Tensor, *, b1: float, b2: float,
                eps: float, wd: float) -> None:
    """AdamW's update of every leaf of p, m and v in place, one launch of
    ``csrc/adamw.cu``: bit-equal to :func:`update_plain` for the same
    ``scalars`` (float32 [4] on the card: clip scale, lr, 1 - b1^t,
    1 - b2^t).  Takes contiguous float32 CUDA tensors; raises on any other
    input and if the launch is refused.  Fake or meta tensors launch
    nothing."""
    g, p, m, v = (list(t) for t in (g, p, m, v))
    _check("update_cuda", g=g, p=p, m=m, v=v)
    if (scalars.dtype != torch.float32 or scalars.shape != (4,)
            or scalars.device != g[0].device or not scalars.is_contiguous()):
        raise ValueError("update_cuda: scalars must be a contiguous float32 "
                         f"[4] tensor on {g[0].device}")
    torch.ops.repro_torch.adamw_update.default(
        g, p, m, v, scalars, float(b1), float(b2), float(eps), float(wd))


update_cuda.launches = 0


def contiguous_grads(g: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients as the kernel takes them: each itself where it is
    contiguous, else a contiguous copy, counted in
    ``contiguous_grads.copies``."""
    out = []
    for t in g:
        if not t.is_contiguous():
            t = t.contiguous()
            contiguous_grads.copies += 1
        out.append(t)
    return out


contiguous_grads.copies = 0


def launches() -> int:
    """The kernel launches of both wrappers so far."""
    return sq_norms_cuda.launches + update_cuda.launches

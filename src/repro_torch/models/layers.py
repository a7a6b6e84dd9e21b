"""Shared building blocks: parameter builder, norms, RoPE, MLPs.

Parameters are plain nested dicts of tensors under the JAX package's key
names (``models/layers.py`` there), so a JAX pytree carries across key for
key (:func:`repro_torch.convert.model_params_from_arrays`).  Master weights
are float32 (:data:`PARAM_DTYPE`); every matrix is cast to bfloat16
(:data:`COMPUTE_DTYPE`) where it is used, by ``partition.wcast`` as in the
reference (under rules it also gathers a sharded weight; ``partition.
wshard`` keeps a model-axis rank's shard local where the block computes
its share: the MLP's ff columns, the vocab rows).  Each parameter
is created with its logical axes; :class:`AxesBuilder` builds the axes
tree of the same layout without allocating anything, and
:class:`ShapeBuilder` its tensors without values (fake under a
``FakeTensorMode``, the twin of ``jax.eval_shape(model.init)``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import partition, spans

Params = Dict[str, Any]

PARAM_DTYPE = torch.float32     # master weights
COMPUTE_DTYPE = torch.bfloat16  # activations / matmul inputs


class ParamBuilder:
    """Creates parameters from one seeded ``torch.Generator`` on ``device``,
    with the reference's initializers (``normal * scale``, ``zeros``,
    ``ones``, ``uniform(0, scale)``).  The draws differ from
    ``jax.random``'s: to compare with the JAX package, carry its
    parameters across instead."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def param(self, shape: Tuple[int, ...], axes: Tuple,
              init: str = "normal", scale: float = 0.02) -> torch.Tensor:
        """A parameter of ``shape``; ``axes`` are its logical axes, one per
        dim (recorded by :class:`AxesBuilder`)."""
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} annotated with {axes}")
        kw = dict(dtype=PARAM_DTYPE, device=self.device)
        if init == "normal":
            return torch.randn(shape, generator=self.generator, **kw) * scale
        if init == "zeros":
            return torch.zeros(shape, **kw)
        if init == "ones":
            return torch.ones(shape, **kw)
        if init == "uniform":  # U(0, scale), as the reference packs it
            return torch.rand(shape, generator=self.generator, **kw) * scale
        raise ValueError(init)


class AxesBuilder:
    """A :class:`ParamBuilder` whose ``param`` returns the logical-axes
    tuple instead of a tensor: the same init code then builds the axes tree
    in the parameters' own layout (``Model.param_axes``)."""

    def param(self, shape: Tuple[int, ...], axes: Tuple,
              init: str = "normal", scale: float = 0.02) -> tuple:
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} annotated with {axes}")
        return tuple(axes)


class ShapeBuilder:
    """A :class:`ParamBuilder` whose ``param`` returns an uninitialised
    ``torch.empty`` of the parameter's shape and dtype on ``device``, with
    no generator: under a ``FakeTensorMode`` a fake tensor, which allocates
    nothing (``Model.param_shapes``)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)

    def param(self, shape: Tuple[int, ...], axes: Tuple,
              init: str = "normal", scale: float = 0.02) -> torch.Tensor:
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} annotated with {axes}")
        return torch.empty(shape, dtype=PARAM_DTYPE, device=self.device)


#: Matrices the forward reads in float32, which a serving copy keeps so: the
#: MoE router and the RG-LRU gates.
FLOAT32_MATRICES = ("router", "wa", "wx")


def serving_copy(params: Params) -> Params:
    """The tree with every floating tensor of two or more dimensions cast to
    :data:`COMPUTE_DTYPE`, except those under the keys of
    :data:`FLOAT32_MATRICES`, and vectors kept as they are.  Exact for the
    forward and decode paths: each other matrix (embedding, head,
    projections, MLP and expert weights, conv weights) is cast to bfloat16
    at every use anyway, while the vectors (norm scales and biases,
    ``a_log``, ``dt_bias``, ``d_skip``, ``lam``) and the kept matrices are
    read in float32.  Halves the weights a server keeps resident."""
    if isinstance(params, dict):
        return {k: (v if k in FLOAT32_MATRICES else serving_copy(v))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(serving_copy(v) for v in params)
    if params.is_floating_point() and params.dim() >= 2:
        return params.to(COMPUTE_DTYPE)
    return params


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embedding.
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim)
    return 1.0 / (theta ** exponent)  # [head_dim // 2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to
    [..., seq]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs    # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    """Fixed sinusoidal table [n, d] float32 (whisper's encoder positions),
    in numpy as the reference computes it."""
    pos = np.arange(n)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    angle = pos / np.power(10_000.0, dim / d)
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


# ---------------------------------------------------------------------------
# MLPs.
# ---------------------------------------------------------------------------


def init_mlp(b: ParamBuilder, d: int, ff: int, mlp_type: str) -> Params:
    if mlp_type in ("swiglu", "geglu"):
        return {"wi": b.param((d, 2 * ff), ("embed", "ff"), scale=0.02),
                "wo": b.param((ff, d), ("ff", "embed"), scale=0.02)}
    if mlp_type in ("squared_relu", "gelu"):
        return {"wi": b.param((d, ff), ("embed", "ff"), scale=0.02),
                "wo": b.param((ff, d), ("ff", "embed"), scale=0.02)}
    raise ValueError(mlp_type)


def _activate(h: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """The MLP's nonlinearity on ``h = x @ wi`` (a gated type's ``[gate |
    up]`` halves side by side)."""
    if mlp_type in ("swiglu", "geglu"):
        gate, up = torch.chunk(h, 2, dim=-1)
        if mlp_type == "swiglu":
            act = F.silu(gate.float())
        else:  # jax.nn.gelu defaults to the tanh approximation
            act = F.gelu(gate.float(), approximate="tanh")
        return act.to(COMPUTE_DTYPE) * up
    if mlp_type == "squared_relu":
        return torch.square(torch.relu(h))
    if mlp_type == "gelu":
        return F.gelu(h.float(), approximate="tanh").to(COMPUTE_DTYPE)
    return h


@spans.spanned("model.mlp")
def mlp(params: Params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """The MLP.  Where the rules split ``ff`` evenly over the model axis,
    tensor-parallel: ``wi`` column-parallel (this rank's ff columns), ``wo``
    row-parallel, the partial outputs summed over the axis.  A gated
    ``wi`` is stored fused, ``[gate | up]``, in the reference's layout,
    its ff shard a block of the fused dim (on two ranks all of ``gate`` on
    one, all of ``up`` on the other): this rank's ``gate`` and ``up``
    columns come from ``partition.fused_product``, which gathers the
    weight whole for a training step or a long prefill and, for a decode
    step's few rows, each rank's product with its stored block instead.
    The compute is sharded either way; an all-to-all of the weight's
    blocks would move 1/m of it, at the price of a collective gloo was
    not probed for."""
    ff = params["wo"].shape[0]
    share = partition.shard_of("ff", ff, "mlp")
    lo, hi = share.lo, share.hi
    x = partition.copy_to_model(x, share)
    if mlp_type in ("swiglu", "geglu"):
        h = partition.fused_product(x, params["wi"], COMPUTE_DTYPE,
                                    ("embed", "ff"), share,
                                    [(lo, hi), (ff + lo, ff + hi)])
    else:
        h = x @ partition.wshard(params["wi"], COMPUTE_DTYPE,
                                 ("embed", "ff"), share)
    h = partition.constrain(_activate(h, mlp_type), ("batch", "seq", "ff"))
    wo = partition.wshard(params["wo"], COMPUTE_DTYPE, ("ff", "embed"), share)
    return partition.row_parallel(h, wo, share)


# ---------------------------------------------------------------------------
# Embedding / unembedding and the cross-entropy.
# ---------------------------------------------------------------------------


@spans.spanned("model.embed")
def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 multiplier: float = 1.0) -> torch.Tensor:
    """Rows of ``table`` in bfloat16 (== cast, then gather; times
    ``multiplier`` in float32 before the cast where it is not 1).  Through
    ``F.embedding``, whose gradient sums the rows of repeated tokens in a
    fixed order on the card, where an indexing gradient adds them with
    atomics: a replayed training step gives the same bits.  A sharded
    table is gathered in its own dtype, so the gradient sums stay
    float32.  Where the rules split ``vocab`` evenly over the model axis,
    vocab-parallel: each rank looks up the tokens of its rows (zeros for
    the others) and the ranks' rows are summed, exactly.  tokens: [B, S]."""
    share = partition.shard_of("vocab", table.shape[0], "embed")
    table = partition.wshard(table, table.dtype, ("vocab", "embed"), share)
    own = (tokens >= share.lo) & (tokens < share.hi)
    out = F.embedding(torch.where(own, tokens - share.lo, 0), table)
    out = partition.reduce_from_model(out.masked_fill(~own[..., None], 0),
                                      share)
    if multiplier != 1.0:
        out = out.float() * multiplier
    return partition.constrain(out.to(COMPUTE_DTYPE),
                               ("batch", "seq", "act_embed"))


def unembed(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Logits in float32 from bfloat16 activations and head; the vocab dim
    carries the "vocab" logical axis: under a split of it, this rank's
    columns (``partition.wshard``)."""
    share = partition.shard_of("vocab", head.shape[1], "unembed")
    logits = partition.copy_to_model(x, share) @ partition.wshard(
        head, COMPUTE_DTYPE, ("embed", "vocab"), share)
    return partition.constrain(logits.float(), ("batch", "seq", "vocab"))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean next-token CE over valid positions (``mask`` 1), in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)

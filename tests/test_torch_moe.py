"""The port's MoE layer against the JAX package's ``models/moe.py`` on the
reduced moe configs: the router's decisions (expert indices, the capacity
``keep`` mask, gates, aux loss) equal the reference's, ``moe_mlp`` matches
the reference's ``moe_mlp``, and with a capacity no token overflows it
matches the dense oracle ``moe_mlp_dense_ref``.

The router runs in float32 on both sides from the same bf16 activations, so
the indices and keep mask are equal and the gates agree to 1e-6; the
routers are random (scale 0.5 here), so no two probabilities tie.  Expert
outputs are bf16 products taken in the same steps on both sides: 2e-2
absolute on outputs up to ~12 (a bf16 ulp there is 6e-2, so most agree
exactly), and 2e-2 of the largest output against the float32 dense
oracle."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ("moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b")
OUT_TOL = 2e-2


def _setup(arch, cf=None, B=2, S=96, seed=0):
    cfg, rcfg = get_config(arch).reduced(), rget_config(arch).reduced()
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
        rcfg = dataclasses.replace(rcfg, capacity_factor=cf)
    rng = np.random.default_rng(seed)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    params = {"router": rng.standard_normal((d, E)) * 0.5,
              "wi": rng.standard_normal((E, d, 2 * ff)) * 0.2,
              "wo": rng.standard_normal((E, ff, d)) * 0.2}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    return (cfg, rcfg, tp, jp, torch.from_numpy(x).to(torch.bfloat16),
            jnp.asarray(x, jnp.bfloat16))


def _reference_routing(params, x, cfg, group=rmoe.DEFAULT_GROUP):
    """The routing lines of the reference's ``moe_mlp`` (it exposes no
    function for them), in jnp."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = rmoe._group(B * S, group)
    G = B * S // T
    C = rmoe._capacity(T, k, E, cfg.capacity_factor)
    logits = (x.reshape(G, T, d).astype(jnp.float32)
              @ params["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate, eidx = jax.lax.top_k(probs, k)
    gate = gate / jnp.maximum(jnp.sum(gate, -1, keepdims=True), 1e-9)
    sel = jax.nn.one_hot(eidx, E, dtype=jnp.int32)
    flatsel = sel.reshape(G, T * k, E)
    pos = jnp.cumsum(flatsel, axis=1) - flatsel
    pos = jnp.sum(pos.reshape(G, T, k, E) * sel, axis=-1)
    return gate, eidx, pos, pos < C, C


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [None, 0.5])
def test_routing_matches_reference(arch, cf):
    """Expert indices, positions and the keep mask equal; at capacity
    factor 0.5 some tokens are dropped, the same ones."""
    cfg, rcfg, tp, jp, tx, jx = _setup(arch, cf)
    gate, eidx, pos, keep, C, aux = moe.moe_routing(tp, tx, cfg)
    rgate, reidx, rpos, rkeep, rC = _reference_routing(jp, jx, rcfg)
    assert C == rC
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(reidx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))
    np.testing.assert_allclose(gate.numpy(), np.asarray(rgate), atol=1e-6)
    if cf == 0.5:
        assert not keep.all()
    _, raux = rmoe.moe_mlp(jp, jx, rcfg)
    assert float(aux) == pytest.approx(float(raux), rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf,group", [(None, 256), (0.5, 256), (None, 64)])
def test_moe_mlp_matches_reference(arch, cf, group):
    cfg, rcfg, tp, jp, tx, jx = _setup(arch, cf)
    y, aux = moe.moe_mlp(tp, tx, cfg, group=group)
    ry, raux = rmoe.moe_mlp(jp, jx, rcfg, group=group)
    assert y.dtype == torch.bfloat16 and y.shape == tx.shape
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ry, np.float32), atol=OUT_TOL)
    assert float(aux) == pytest.approx(float(raux), rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_without_drops_matches_dense_oracle(arch):
    """With a capacity no expert's load can reach (factor E / k), nothing
    is dropped and the capacity dispatch is the dense top-k sum."""
    cfg = get_config(arch).reduced()
    cfg, rcfg, tp, jp, tx, jx = _setup(arch, cf=cfg.n_experts / cfg.top_k)
    assert moe.moe_routing(tp, tx, cfg)[3].all()
    y, _ = moe.moe_mlp(tp, tx, cfg)
    dense = moe.moe_mlp_dense_ref(tp, tx, cfg)
    # The reference's own bar (tests/test_layers.py, 2e-2 on its outputs of
    # ~0.1) taken against the size of these (max ~12); measured 5.0e-3.
    scale = dense.float().abs().max()
    assert ((y.float() - dense.float()).abs().max() / scale) <= 2e-2
    rdense = rmoe.moe_mlp_dense_ref(jp, jx, rcfg)
    np.testing.assert_allclose(dense.float().numpy(),
                               np.asarray(rdense, np.float32), atol=1e-2)


def test_group_and_capacity_are_the_references():
    for n in (1, 7, 96, 256, 16384, 1000):
        for g in (64, 256):
            assert moe._group(n, g) == rmoe._group(n, g)
    for t, k, e, cf in ((256, 6, 64, 1.25), (256, 8, 128, 1.25),
                        (2, 6, 64, 1.25), (96, 2, 8, 0.5)):
        assert moe._capacity(t, k, e, cf) == rmoe._capacity(t, k, e, cf)

"""The port's RG-LRU layer against the JAX package's ``models/rglru.py``:
the parallel prefix ``rglru_scan`` against the sequential oracle
``rglru_reference`` in float32 (rel 1e-5: the two sum the same products in
another order) and against the JAX ``rglru_scan`` (``associative_scan``,
the same bar), with and without an initial state; the recurrent block's
prefill against its token-by-token decode (2e-2 of the largest output);
and the block against the reference's on bf16 activations (2e-2 absolute on
outputs up to ~34: the two take the same bf16 steps)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.models import rglru as rrglru  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import rglru  # noqa: E402

ARCH = "recurrentgemma-2b"


def _params(r, d, conv_width, seed=0):
    """Block parameters as float32 numpy at scales that make the gates and
    decays vary across (0, 1)."""
    rng = np.random.default_rng(seed)
    p = {"w_gate": rng.standard_normal((d, r)) * 0.3,
         "w_in": rng.standard_normal((d, r)) * 0.3,
         "conv_w": rng.standard_normal((conv_width, r)) * 0.5,
         "conv_b": rng.standard_normal(r) * 0.1,
         "wa": rng.standard_normal((r, r)) * 0.3,
         "ba": rng.standard_normal(r) * 0.5,
         "wx": rng.standard_normal((r, r)) * 0.3,
         "bx": rng.standard_normal(r) * 0.5,
         "lam": rng.uniform(0.0, 1.0, r),
         "w_out": rng.standard_normal((r, d)) * 0.3}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p):
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("S", [1, 7, 64, 200])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_matches_sequential_and_jax(S, with_h0):
    r = 48
    tp, jp = _both(_params(r, 32, 4, seed=S))
    rng = np.random.default_rng(S + 1)
    x = rng.standard_normal((2, S, r)).astype(np.float32)
    h0 = rng.standard_normal((2, r)).astype(np.float32) if with_h0 else None
    th0 = None if h0 is None else torch.from_numpy(h0)
    h, h_last = rglru.rglru_scan(tp, torch.from_numpy(x), th0)
    seq = rglru.rglru_reference(tp, torch.from_numpy(x), th0)
    assert h.dtype == torch.float32 and h.shape == (2, S, r)
    np.testing.assert_allclose(h.numpy(), seq.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(h_last.numpy(), h[:, -1].numpy())
    jh, jlast = rrglru.rglru_scan(jp, jnp.asarray(x),
                                  None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        seq.numpy(), np.asarray(rrglru.rglru_reference(
            jp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))),
        rtol=1e-5, atol=1e-6)


def test_block_prefill_matches_decode_and_reference():
    cfg = get_config(ARCH).reduced()
    r, d = cfg.rnn_width_, cfg.d_model
    tp, jp = _both(_params(r, d, cfg.conv_width, seed=9))
    x = np.random.default_rng(10).standard_normal((2, 12, d)).astype(
        np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    y, (conv, h) = rglru.recurrent_block(tp, tx, cfg, return_state=True)
    ry, (rconv, rh) = rrglru.recurrent_block(
        jp, jnp.asarray(x, jnp.bfloat16), rget_config(ARCH).reduced(),
        return_state=True)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ry, np.float32),
                               atol=2e-2)
    np.testing.assert_allclose(conv.float().numpy(),
                               np.asarray(rconv, np.float32), atol=1e-2)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=2e-2)
    # The same tokens one at a time from the zero state.
    state = rglru.init_rglru_state(cfg, 2)
    steps = []
    for t in range(x.shape[1]):
        yt, state = rglru.recurrent_block_decode(tp, tx[:, t], cfg, state)
        steps.append(yt)
    # Decode sums the conv taps in one reduction where prefill adds them
    # one by one, in bf16: outputs up to ~34 move by bf16 ulps (measured
    # 0.18, 0.5% of the largest).
    scale = float(y.float().abs().max())
    np.testing.assert_allclose(torch.stack(steps, 1).float().numpy(),
                               y.float().numpy(), atol=2e-2 * scale)
    np.testing.assert_array_equal(state[0].float().numpy(),
                                  conv.float().numpy())
    np.testing.assert_allclose(state[1].numpy(), h.numpy(),
                               atol=2e-2 * float(h.abs().max()))

"""The sequence-sharded flash-decode (``models/attention.py``:
``decode_attention_sharded``, ``cache_insert``, ``pack_cache``,
``init_decode_cache`` under rules that shard ``cache_seq``) on 2 and 4
gloo ranks on the CPU, against the unsharded port on the whole cache; and
a reduced model of every served family by ``Server`` under
``serve_rules`` on a (1, 2) mesh against the JAX package's ``Model``.

Bars: the combine sums each rank's partial in another order than the
unsharded softmax, so the decode output is held at rel 1e-5 of its max with
the attention computing in float32 (measured 1.2e-7), not bit for bit.  In
the model's bfloat16 the reference's algorithm rounds each probability to
bfloat16 against its own rank's max, not the global one: one bfloat16
rounding (2^-9 relative) an element, so 2e-3 of the max there (measured
7.0e-4).  The ring insert is exact.  The served logits keep
``tests/test_torch_models.py``'s 2e-2 against the JAX model.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_ranks  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.models.model import Model as RModel  # noqa: E402
from repro_torch import partition  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

DECODE_REL = {"float32": 1e-5, "bfloat16": 2e-3}
LOGIT_BAR = 2e-2

# (B, H, KV, dh, W, cache_len, window, insert positions, seed)
CASES = {
    "causal": (2, 8, 2, 16, 32, 21, None, (), 0),
    "causal_full": (2, 8, 2, 16, 32, 32, None, (), 1),
    "window": (2, 8, 4, 16, 32, 29, 12, (), 2),
    # W 16: slices of 8 (2 ranks) or 4 (4 ranks); 7 | 8 and 23 | 24 land on
    # the last position of one slice and the first of the next, 11 | 12 on
    # a 4-rank boundary; the ring wraps at 16.
    "ring_boundary": (2, 4, 1, 16, 16, 16, None, (7, 8, 11, 12, 23, 24), 3),
}


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("dtype", sorted(DECODE_REL))
def test_sharded_decode_equals_unsharded(world, dtype, tmp_path):
    out = _torch_ranks.run_ranks(_torch_ranks.decode_rank, world, tmp_path,
                                 CASES, dtype)
    for r in out:
        assert set(r) == set(CASES)
        for case, got in r.items():
            want = got["want"].numpy()
            err = np.abs(got["out"].numpy() - want).max() / np.abs(want).max()
            assert err <= DECODE_REL[dtype], (case, err)
            assert torch.equal(got["cache"], got["want_cache"]), case


def test_without_rules_the_cache_is_whole():
    """No rules: one slice, the whole window, the reference's branch."""
    assert attn.local_window(48) == 48 and attn.global_window(48) == 48
    cfg = rget_config("h2o-danube-1.8b").reduced()
    (k, v), axes = attn.init_decode_cache(cfg, 2, 3, 40)
    assert k.shape == (2, 3, 40, 2, 16) and v.shape == k.shape
    assert axes == ("layers", "batch", "cache_seq", None, None)
    (k, _), _ = attn.init_decode_cache(cfg, 2, 3, 40, window=32)
    assert k.shape == (2, 3, 32, 2, 16)


def test_a_cache_that_does_not_split_raises():
    class Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return (1, 3)[i]

        def get_local_rank(self, name):
            return 0

    with partition.use_rules(partition.serve_rules(Mesh(), 2)):
        assert attn.local_window(33) == 11
        with pytest.raises(ValueError, match="does not split"):
            attn.local_window(32)


# Every served family (the moe router, the SSM and RG-LRU gates, the
# encdec cross-attention over an unsharded encoder cache, the vlm prefix);
# the attention families' self-attention caches split over the ranks.
SERVED = ("h2o-danube-1.8b", "mamba2-370m", "moonshot-v1-16b-a3b",
          "recurrentgemma-2b", "whisper-base", "internvl2-2b")


def _extras(cfg, B, seed=2):
    """The family's prefill inputs beside the tokens (float32 numpy, rounded
    to bf16 by each model), as ``tests/test_torch_models.py`` makes them."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"patch_embeds": 0.5 * rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"frames": 0.5 * rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)}
    return {}


@pytest.mark.parametrize("arch", SERVED)
def test_reduced_model_served_on_two_ranks_matches_jax(arch, tmp_path):
    rm = RModel(rget_config(arch).reduced())
    rparams, _ = rm.init(jax.random.key(0))
    arrays = jax.tree.map(np.asarray, rparams)
    s0, steps, max_seq = 16, 4, 32
    tok = np.random.default_rng(1).integers(0, rm.cfg.vocab_size,
                                            (2, s0 + steps))
    extras = _extras(rm.cfg, 2)
    want = []
    rl, rc = rm.prefill(rparams, {"tokens": jnp.asarray(tok[:, :s0]),
                                  **{k: jnp.asarray(v, jnp.bfloat16)
                                     for k, v in extras.items()}},
                        max_seq=max_seq)
    want.append(np.asarray(rl))
    decode = jax.jit(rm.decode_step)
    for t in range(s0, s0 + steps):
        rl, rc = decode(rparams, rc, jnp.asarray(tok[:, t]), jnp.asarray(t))
        want.append(np.asarray(rl))
    out = _torch_ranks.run_ranks(_torch_ranks.serve_rank, 2, tmp_path,
                                 arch, arrays, tok, extras, s0, max_seq)
    window = min(max_seq, rm.cfg.sliding_window or max_seq)
    if rm.cfg.family == "hybrid":
        window = min(max_seq, rm.cfg.local_window)
    for r in out:
        assert all(w == window // 2 for w in r["kv_positions"])
        assert bool(r["kv_positions"]) == (rm.cfg.family != "ssm")
        assert r["new_tokens"] == 2 * 4
        assert any("Shard" in p for p in r["placements"])
        for got, ref in zip(r["logits"], want):
            np.testing.assert_allclose(got, ref, atol=LOGIT_BAR)

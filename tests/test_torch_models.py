"""The port's model stack against the JAX package, on reduced configs of
every family (h2o-danube-1.8b: dense, GQA, sliding window; mamba2-370m:
ssm; moonshot-v1-16b-a3b and qwen3-moe-30b-a3b: moe; recurrentgemma-2b:
hybrid RG-LRU + local attention; whisper-base: encdec; internvl2-2b: vlm
with its bidirectional image prefix).  The JAX parameters
(``Model.init(jax.random.key(0))``) carry across through
``convert.model_params_from_arrays``; vlm patch embeddings and encdec
frames are seeded numpy arrays fed to both.

Bars on logits, no looser than the JAX package's own 0.05
(``tests/test_decode_consistency.py``): 2e-2 absolute against the JAX
model (measured: <= 6e-3 on logits whose max is 0.5-1.0; torch rounds
bf16 element-wise work after every op, XLA may keep float32 inside a
fusion); 2e-2 for the port's own prefill against
decode (measured <= 6e-3), except for moe, where the reference's own
check (``tests/test_decode_consistency.py``) allows 0.15 for capacity
routing: prefill groups 2 x S tokens, decode 2, so other tokens are
dropped.  The caches: 1e-2 on bf16 K/V and conv state (one ulp), 1e-5 on
the float32 SSM state, 1e-4 on the float32 RG-LRU state."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models.model import Model as RModel  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.convert import model_params_from_arrays  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

SERVED = ("h2o-danube-1.8b", "mamba2-370m", "moonshot-v1-16b-a3b",
          "qwen3-moe-30b-a3b", "recurrentgemma-2b", "whisper-base",
          "internvl2-2b")
LOGIT_BAR = 2e-2
MOE_CONSIST_BAR = 0.15
CACHE_TOL = {"ssm": 1e-5, "h": 1e-4}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


_MODELS = {}


def _pair(arch):
    """(JAX model, its params, port model, converted params, jitted JAX
    decode step), once per arch and process."""
    if arch not in _MODELS:
        rm = RModel(rget_config(arch).reduced())
        rparams, _ = rm.init(jax.random.key(0))
        cfg = get_config(arch).reduced()
        params = model_params_from_arrays(
            cfg, jax.tree.map(np.asarray, rparams), device="cpu")
        _MODELS[arch] = (rm, rparams, Model(cfg, device="cpu"), params,
                         jax.jit(rm.decode_step))
    return _MODELS[arch]


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _extras(cfg, B, seed=2):
    """The family's prefill inputs beside the tokens, as float32 numpy: vlm
    patch embeddings, encdec audio frames (both rounded to bf16 by each
    model)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"patch_embeds": 0.5 * rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"frames": 0.5 * rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)}
    return {}


def _jbatch(cfg, tok):
    return {"tokens": jnp.asarray(tok),
            **{k: jnp.asarray(v, jnp.bfloat16)
               for k, v in _extras(cfg, tok.shape[0]).items()}}


def _tbatch(cfg, tok):
    return {"tokens": torch.as_tensor(tok),
            **{k: torch.from_numpy(v).to(torch.bfloat16)
               for k, v in _extras(cfg, tok.shape[0]).items()}}


def _flat(tree, prefix=""):
    """{path: leaf} of a cache or parameter tree (dicts, tuples, lists)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_decode_match_jax(arch):
    rm, rparams, m, params, rdecode = _pair(arch)
    S0, steps = 16, 4
    tok = _tokens(m.cfg, 2, S0 + steps)
    rl, rc = rm.prefill(rparams, _jbatch(m.cfg, tok[:, :S0]), max_seq=32)
    tl, tc = m.prefill(params, _tbatch(m.cfg, tok[:, :S0]), max_seq=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=LOGIT_BAR)
    got, want = _flat(tc), _flat(rc)
    assert set(got) == set(want)
    for key, ref in want.items():
        assert tuple(got[key].shape) == ref.shape, key
        tol = CACHE_TOL.get(key.rsplit("/", 1)[-1], 1e-2)
        np.testing.assert_allclose(_f32(got[key]), _f32(ref), atol=tol,
                                   err_msg=key)
    for t in range(S0, S0 + steps):
        rl, rc = rdecode(rparams, rc, jnp.asarray(tok[:, t]), jnp.asarray(t))
        tl, tc = m.decode_step(params, tc, torch.from_numpy(tok[:, t]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl),
                                   atol=LOGIT_BAR)


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_against_decode(arch):
    """prefill(tokens[:, :S0]) then decode steps fed the known tokens give
    the last logits of prefill(tokens[:, :S0 + j])."""
    m, params = _pair(arch)[2:4]
    S0, steps = 12, 4
    tok = _tokens(m.cfg, 2, S0 + steps, seed=3)
    bar = MOE_CONSIST_BAR if m.cfg.family == "moe" else LOGIT_BAR
    logits, cache = m.prefill(params, _tbatch(m.cfg, tok[:, :S0]), max_seq=32)
    for j in range(1, steps + 1):
        logits, cache = m.decode_step(params, cache,
                                      torch.from_numpy(tok[:, S0 + j - 1]),
                                      S0 + j - 1)
        want, _ = m.prefill(params, _tbatch(m.cfg, tok[:, :S0 + j]),
                            max_seq=32)
        np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=bar)


@pytest.mark.parametrize("arch", SERVED)
def test_forward_against_prefill(arch):
    """The training forward and prefill run the same layers: the forward's
    last position (normed already) through the head, as ``Model._logits``
    takes it, gives prefill's logits."""
    m, params = _pair(arch)[2:4]
    batch = _tbatch(m.cfg, _tokens(m.cfg, 2, 12, seed=8))
    with torch.no_grad():
        x, _ = m.forward(params, batch, remat=False)
    logits = (x[:, -1] @ m.head_matrix(params).to(torch.bfloat16)).float()
    logits = m._mask_pad_logits(logits / m.cfg.logits_scaling)
    want, _ = m.prefill(params, batch, max_seq=16)
    bar = MOE_CONSIST_BAR if m.cfg.family == "moe" else LOGIT_BAR
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=bar)


def test_ring_buffer_wraparound_matches_jax():
    """Decode far past danube's reduced window W = 32: the ring cache keeps
    exactly the last W tokens.  Both models are fed JAX's greedy tokens, so
    a drift would show as a logit gap, not as a diverged sequence."""
    rm, rparams, m, params, rdecode = _pair("h2o-danube-1.8b")
    W = m.cfg.sliding_window
    S0 = 8
    tok = _tokens(m.cfg, 2, S0, seed=4)
    rl, rc = rm.prefill(rparams, {"tokens": jnp.asarray(tok)}, max_seq=W)
    tl, tc = m.prefill(params, {"tokens": torch.from_numpy(tok)}, max_seq=W)
    assert tc["k"].shape[2] == W
    for t in range(S0, S0 + W + 12):
        cur = np.array(jnp.argmax(rl, -1))
        rl, rc = rdecode(rparams, rc, jnp.asarray(cur), jnp.asarray(t))
        tl, tc = m.decode_step(params, tc, torch.from_numpy(cur), t)
        assert bool(torch.isfinite(tl).all())
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl),
                                   atol=LOGIT_BAR)
    np.testing.assert_allclose(_f32(tc["k"]), _f32(rc["k"]), atol=1e-2)


def test_hybrid_ring_buffer_wraparound_matches_jax():
    """recurrentgemma-2b's local attention past its reduced window of 32:
    the attention layers' ring caches and the RG-LRU states, decoded on
    JAX's greedy tokens."""
    rm, rparams, m, params, rdecode = _pair("recurrentgemma-2b")
    W = m.cfg.local_window
    tok = _tokens(m.cfg, 2, 8, seed=6)
    rl, rc = rm.prefill(rparams, {"tokens": jnp.asarray(tok)}, max_seq=W)
    tl, tc = m.prefill(params, {"tokens": torch.from_numpy(tok)}, max_seq=W)
    for t in range(8, 8 + W + 12):
        cur = np.array(jnp.argmax(rl, -1))
        rl, rc = rdecode(rparams, rc, jnp.asarray(cur), jnp.asarray(t))
        tl, tc = m.decode_step(params, tc, torch.from_numpy(cur), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl),
                                   atol=LOGIT_BAR)
    # The float32 RG-LRU state after 44 steps of bf16 inputs that may differ
    # by an ulp, decays near 1 adding them up: 1e-3 (measured 1.3e-4).
    got, want = _flat(tc), _flat(rc)
    for key, ref in want.items():
        tol = 1e-3 if key.endswith("/h") else 1e-2
        np.testing.assert_allclose(_f32(got[key]), _f32(ref), atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("arch", SERVED)
def test_serving_copy_is_exact(arch):
    """bf16 matrices, float32 vectors: the forward casts every matrix to
    bf16 at use, so prefill is bit-identical."""
    m, params = _pair(arch)[2:4]
    tok = _tokens(m.cfg, 2, 10, seed=5)
    want, wc = m.prefill(params, _tbatch(m.cfg, tok), max_seq=16)
    served = layers.serving_copy(params)
    got, gc = m.prefill(served, _tbatch(m.cfg, tok), max_seq=16)
    assert torch.equal(got, want)
    got_c, want_c = _flat(gc), _flat(wc)
    assert set(got_c) == set(want_c)
    for key in want_c:
        assert torch.equal(got_c[key], want_c[key]), key
    # The matrices the forward reads in float32 stay float32.
    for path, t in _flat(served).items():
        name = path.rsplit("/", 1)[-1]
        want_dt = (torch.float32 if name in layers.FLOAT32_MATRICES
                   or t.dim() < 2 else torch.bfloat16)
        assert t.dtype == want_dt, path


@pytest.mark.parametrize("arch", SERVED)
def test_init_shapes_match_jax(arch):
    rm, rparams, m = _pair(arch)[:3]
    mine = m.init(0)
    conv = model_params_from_arrays(
        m.cfg, jax.tree.map(lambda x: np.zeros(x.shape, np.float32), rparams),
        device="cpu")

    def shapes(tree):
        return {k: (tuple(t.shape), t.dtype) for k, t in _flat(tree).items()}

    assert shapes(mine) == shapes(conv)


def twin_fields(cfg) -> dict:
    """The fields of a port config that the JAX package's has too; the
    port's own (``PORT_FIELDS``) must sit at their neutral values."""
    import dataclasses
    from repro_torch.models.config import PORT_FIELDS
    fields = dataclasses.asdict(cfg)
    assert {k: fields.pop(k) for k in PORT_FIELDS} == PORT_FIELDS
    return fields


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    """The ten twins field for field (``granite-4.0-h-micro``, the one
    port-only architecture, has no JAX config: ``tests/
    test_torch_hybrid.py`` holds it to the benchmark's reference)."""
    import dataclasses
    mine, theirs = get_config(arch), rget_config(arch)
    assert twin_fields(mine) == dataclasses.asdict(theirs)
    assert mine.param_count() == theirs.param_count()
    assert twin_fields(mine.reduced()) == \
        dataclasses.asdict(theirs.reduced())


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "squared_relu",
                                      "gelu"])
def test_mlp_matches_reference(mlp_type):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ff = 48
    wi = (rng.standard_normal((32, 2 * ff if "glu" in mlp_type else ff))
          * 0.1).astype(np.float32)
    wo = (rng.standard_normal((ff, 32)) * 0.1).astype(np.float32)
    want = rlayers.mlp({"wi": jnp.asarray(wi), "wo": jnp.asarray(wo)},
                       jnp.asarray(x, jnp.bfloat16), mlp_type)
    got = layers.mlp({"wi": torch.from_numpy(wi), "wo": torch.from_numpy(wo)},
                     torch.from_numpy(x).to(torch.bfloat16), mlp_type)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2)


def test_norms_and_rope_match_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    bias = rng.standard_normal(16).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(rlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-5)
    np.testing.assert_allclose(
        layers.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                          torch.from_numpy(bias)).numpy(),
        np.asarray(rlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias))), atol=1e-5)
    pos = np.arange(6)[None, :]
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          10_000.0).numpy(),
        np.asarray(rlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      10_000.0)), atol=1e-5)


def test_convert_rejects_a_wrong_depth():
    rm, rparams, m = _pair("mamba2-370m")[:3]
    tree = jax.tree.map(np.asarray, rparams)
    import dataclasses
    deeper = dataclasses.replace(m.cfg, n_layers=m.cfg.n_layers + 1)
    with pytest.raises(ValueError, match="layer stacks"):
        model_params_from_arrays(deeper, tree, device="cpu")


@pytest.mark.parametrize("arch,key", [("h2o-danube-1.8b", "rem_layers"),
                                      ("recurrentgemma-2b", "enc_layers"),
                                      ("whisper-base", "router")])
def test_convert_rejects_a_layout_of_another_family(arch, key):
    rm, rparams, m = _pair(arch)[:3]
    tree = dict(jax.tree.map(np.asarray, rparams))
    tree[key] = tree["final_norm"]
    with pytest.raises(ValueError, match="no part of"):
        model_params_from_arrays(m.cfg, tree, device="cpu")


def full_width_gap(arch: str, n_layers: int, s0: int = 60, steps: int = 4):
    """Prefill against decode at the published width, cut to ``n_layers``:
    max |decode - prefill| logits over max |prefill| logits, for the JAX
    model and for the port on the same parameters (CPU).  Too slow for the
    suite; run as ``python tests/test_torch_models.py ARCH LAYERS``."""
    import dataclasses
    rcfg = dataclasses.replace(rget_config(arch), n_layers=n_layers)
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    rm = RModel(rcfg)
    rparams, _ = rm.init(jax.random.key(0))
    m = Model(cfg, device="cpu")
    params = model_params_from_arrays(cfg, jax.tree.map(np.asarray, rparams),
                                      device="cpu")
    tok = _tokens(cfg, 2, s0 + steps, seed=0)
    max_seq = s0 + steps + 16
    rpre = jax.jit(lambda t: rm.prefill(rparams, {"tokens": t},
                                        max_seq=max_seq))
    rdec = jax.jit(lambda c, x, t: rm.decode_step(rparams, c, x, t))
    sides = {
        "jax": (lambda t: rpre(jnp.asarray(t)),
                lambda c, x, t: rdec(c, jnp.asarray(x), jnp.asarray(t))),
        "port": (lambda t: m.prefill(params, {"tokens": torch.from_numpy(t)},
                                     max_seq),
                 lambda c, x, t: m.decode_step(params, c,
                                               torch.from_numpy(x), t))}
    out = {}
    for name, (pre, dec) in sides.items():
        logits, cache = pre(tok[:, :s0])
        err = scale = 0.0
        for j in range(1, steps + 1):
            logits, cache = dec(cache, tok[:, s0 + j - 1], s0 + j - 1)
            want, _ = pre(tok[:, :s0 + j])
            got_v, want_v = (_f32(x)[:, :cfg.vocab_size] for x in (logits,
                                                                   want))
            err = max(err, float(np.abs(got_v - want_v).max()))
            scale = max(scale, float(np.abs(want_v).max()))
        out[name] = err / scale
    return out


if __name__ == "__main__":
    import sys
    arch_, layers_ = sys.argv[1], int(sys.argv[2])
    print(arch_, layers_, "layers, prefill vs decode err/max:",
          full_width_gap(arch_, layers_))

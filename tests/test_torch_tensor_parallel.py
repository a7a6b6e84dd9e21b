"""Tensor and expert parallelism on the model axis (``partition.py``'s
``wshard``, ``copy_to_model``, ``row_parallel``, ``shard_of`` and the
blocks that use them) on gloo ranks on the CPU: every served family's
reduced config on (1, 2), (1, 4) and (2, 2) meshes under ``serve_rules``
and ``fsdp_rules`` and one train step under ``fsdp_rules``, against the
JAX package's ``Model`` on the same parameters; the shapes each rank's
kernels and weight reads ran at; the vocab-parallel cross-entropy and the
cross-shard argmax against the whole vocab's; and a (1, 3) mesh, which
divides none of the reduced heads, experts, SSM heads, RG-LRU width or
vocab (it divides ff 96), where those blocks repeat on every rank and are
counted.

Bars are ``tests/test_torch_models.py``'s and ``tests/test_torch_train.py``'s:
logits within 2e-2 of the JAX model's (measured <= 5.6e-3), the loss
within rel 2e-3 (measured <= 2.4e-5), the grad norm within rel 2e-2
(measured <= 1.3e-3), and every gradient leaf at cosine >= 0.99 with the
JAX package's (measured >= 0.9992).  The vocab-parallel cross-entropy
sums the ranks' partial exponentials in another order than the whole
row's ``logsumexp``: within rel 1e-6, and its gradients within one
bfloat16 step at their largest element (the products are bfloat16);
the argmax is exact, ties to the smallest index.  The greedy tokens
equal the argmax of the gathered logits bit for bit, and the JAX model's
wherever its top two logits are further apart than twice the logit
bar.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

import _torch_ranks  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RData  # noqa: E402
from repro.models.model import Model as RModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (model_params_from_arrays,  # noqa: E402
                                 model_params_to_arrays)

LOGIT_BAR, LOSS_REL, GNORM_REL, LEAF_COS = 2e-2, 2e-3, 2e-2, 0.99
CE_REL = 1e-6
#: The cross-entropy's gradients pass through bfloat16 products (x is
#: bfloat16), which the ranks round apart: one bfloat16 step at the largest
#: element (at most 2^-7 of it).
GRAD_BAR = 2.0 ** -7
SERVED = ("h2o-danube-1.8b", "mamba2-370m", "moonshot-v1-16b-a3b",
          "recurrentgemma-2b", "whisper-base", "internvl2-2b")
S0, STEPS, MAX_SEQ, B = 16, 2, 32, 2


def _extras(cfg, B, seed=2):
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"patch_embeds": 0.5 * rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"frames": 0.5 * rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)}
    return {}


@pytest.fixture(scope="module")
def cases():
    """Per family: the JAX model's parameters, prompt and teacher-forced
    tokens, its prefill and decode logits, a training batch and the JAX
    loss and gradients (as the port's leaves)."""
    out = []
    for arch in SERVED:
        rm = RModel(rget_config(arch).reduced())
        rparams, _ = rm.init(jax.random.key(0))
        arrays = jax.tree.map(np.asarray, rparams)
        tok = np.random.default_rng(1).integers(0, rm.cfg.vocab_size,
                                                (B, S0 + STEPS))
        extras = _extras(rm.cfg, B)
        logits, cache = rm.prefill(
            rparams, {"tokens": jnp.asarray(tok[:, :S0]),
                      **{k: jnp.asarray(v, jnp.bfloat16)
                         for k, v in extras.items()}}, max_seq=MAX_SEQ)
        want = [np.asarray(logits)]
        for t in range(S0, S0 + STEPS):
            logits, cache = rm.decode_step(rparams, cache,
                                           jnp.asarray(tok[:, t]),
                                           jnp.asarray(t))
            want.append(np.asarray(logits))
        rows = 8 if rm.cfg.family == "moe" else 4
        batch = RData.for_config(rm.cfg, 64, rows, seed=0,
                                 mode="succ").batch(0)
        (loss, _), grads = jax.value_and_grad(
            lambda p: rm.loss_fn(p, {k: jnp.asarray(v)
                                     for k, v in batch.items()}),
            has_aux=True)(rparams)
        out.append({"arch": arch, "arrays": arrays, "tokens": tok,
                    "extras": extras, "s0": S0, "max_seq": MAX_SEQ,
                    "batch": {k: np.asarray(v) for k, v in batch.items()},
                    "want": want, "loss": float(loss),
                    "grads": jax.tree.leaves(jax.tree.map(np.asarray,
                                                          grads))})
    return out


def _cos(a, b):
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def _check_against_jax(case, res):
    cfg = get_config(case["arch"]).reduced()
    for kind in ("serve", "fsdp"):
        got = res[kind]
        for x, w in zip(got["logits"], case["want"]):
            np.testing.assert_allclose(x, w, atol=LOGIT_BAR)
        for tokens, top, w in zip(got["greedy"], got["argmax"],
                                  case["want"]):
            np.testing.assert_array_equal(tokens, top)
            part = np.sort(w, axis=-1)
            clear = part[:, -1] - part[:, -2] > 2 * LOGIT_BAR
            np.testing.assert_array_equal(tokens[clear],
                                          np.argmax(w, -1)[clear])
    train = res["train"]
    assert abs(train["loss"] - case["loss"]) <= LOSS_REL * case["loss"]
    spec = pytree.tree_structure(model_params_from_arrays(
        cfg, case["arrays"], device="cpu"))
    got = jax.tree.leaves(model_params_to_arrays(
        cfg, pytree.tree_unflatten(train["grads"], spec)))
    gn = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                     for g in case["grads"]))
    assert abs(train["grad_norm"] - gn) <= GNORM_REL * gn
    assert len(got) == len(case["grads"])
    for g, w in zip(got, case["grads"]):
        assert g.shape == w.shape
        assert _cos(g, w) >= LEAF_COS


def _local_shapes(cfg, res, m):
    """Each rank's kernels ran at its share: H / m query heads (and the kv
    heads they use), H_ssm / m SSD heads, E / m experts, V / m logits."""
    for kind in ("serve", "fsdp", "train"):
        rec = res[kind]
        assert rec["repeats"] == {}, (kind, rec["repeats"])
        for q, k in rec["attn"]:
            assert q[2] == cfg.n_heads // m
            assert k[2] == max(1, cfg.n_kv_heads // m)
        for x in rec["ssd"]:
            assert x[2] == cfg.n_ssm_heads // m
        if cfg.family == "moe":
            wi = [s for axes, name, s in rec["shards"] if name == "expert"]
            assert wi and all(s[0] == cfg.n_experts // m for s in wi)
        if kind != "train":
            assert rec["local_vocab"] == cfg.padded_vocab // m
    fam = cfg.family
    assert bool(res["serve"]["attn"]) == (fam != "ssm")
    assert bool(res["serve"]["ssd"]) == (fam == "ssm")


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4), (2, 2)],
                         ids=["1x2", "1x4", "2x2"])
def test_every_family_splits_the_model_axis_and_matches_jax(mesh, cases,
                                                            tmp_path):
    out = _torch_ranks.run_ranks(_torch_ranks.tp_rank, mesh[0] * mesh[1],
                                 tmp_path, mesh[0],
                                 [{k: v for k, v in c.items()
                                   if k not in ("want", "loss", "grads")}
                                  for c in cases], timeout=600)
    for r in out:
        for case in cases:
            res = r[case["arch"]]
            _check_against_jax(case, res)
            _local_shapes(get_config(case["arch"]).reduced(), res, mesh[1])


# What a (1, 3) mesh repeats, per family: every block but the MLP (ff 96).
REPEATED = {"dense": {"attention", "embed", "logits", "cross_entropy"},
            "ssm": {"ssm", "embed", "logits", "cross_entropy"},
            "moe": {"attention", "moe", "embed", "logits", "cross_entropy"},
            "hybrid": {"attention", "rglru", "embed", "logits",
                       "cross_entropy"},
            "encdec": {"attention", "embed", "logits", "cross_entropy"},
            "vlm": {"attention", "embed", "logits", "cross_entropy"}}


def test_a_model_axis_that_divides_nothing_repeats_and_counts(cases,
                                                              tmp_path):
    """On (1, 3) the blocks whose dims 3 does not divide gather their
    weights and repeat on every rank (counted in ``Rules.repeats``), the
    MLP splits its ff columns, and every family holds the JAX bars."""
    out = _torch_ranks.run_ranks(
        _torch_ranks.tp_rank, 3, tmp_path, 1,
        [dict({k: v for k, v in c.items()
               if k not in ("want", "loss", "grads")}, max_seq=24)
         for c in cases], timeout=600)
    for r in out:
        for case in cases:
            cfg = get_config(case["arch"]).reduced()
            res = r[case["arch"]]
            _check_against_jax(case, res)
            seen = set(res["serve"]["repeats"]) | set(res["train"]["repeats"])
            assert seen == REPEATED[cfg.family], (case["arch"], seen)
            assert res["serve"]["local_vocab"] == cfg.padded_vocab
            for q, _ in res["serve"]["attn"]:
                assert q[2] == cfg.n_heads
            ff = [s[axes.index("ff")] for axes, name, s
                  in res["train"]["shards"] if name == "ff"]
            assert all(n == cfg.d_ff // 3 for n in ff)
            assert bool(ff) == (cfg.family != "ssm"
                                and cfg.family != "moe")


#: The blocks ``repeat_rank`` calls on (1, 3), by the block each counts.
REPEATS_ON_1X3 = {"rglru": "rglru", "rglru_decode": "rglru", "ssm": "ssm",
                  "ssm_decode": "ssm", "attention": "attention",
                  "moe": "moe"}


def test_a_repeated_block_computes_what_one_device_does(tmp_path):
    """On (1, 3) a block whose dim 3 does not divide repeats the whole
    compute on every rank: its output, its input's gradient and its
    weights' gradients are those of the same call without rules, within
    1e-5 of their largest element in float32 (they are the same
    operations, so equal); a block that summed the ranks' whole outputs
    would read 2 (three times the output)."""
    out = _torch_ranks.run_ranks(_torch_ranks.repeat_rank, 3, tmp_path,
                                 timeout=300)
    for r in out:
        assert set(r) == set(REPEATS_ON_1X3)
        for name, block in REPEATS_ON_1X3.items():
            res = r[name]
            assert res["repeats"] == {block: 1}, (name, res["repeats"])
            for key in ("out", "dx", "dw"):
                assert res[key] <= 1e-5, (name, key, res[key])


@pytest.mark.parametrize("world", [2, 3])
def test_vocab_parallel_cross_entropy_and_argmax(world, tmp_path):
    """48 vocab columns (40 valid) split over 2 or 3 ranks: the chunked
    cross-entropy and its gradients against the whole vocab's, and the
    cross-shard argmax against ``torch.argmax`` on rows with ties across
    and within the shards.  And a remat'd loss differentiated on a thread
    that binds no rules (as a CUDA backward runs) gives the gradients of
    one differentiated under them: the recompute keeps the forward's
    rules.  And ``global_norm`` counts a leaf sharded over the model axis
    once across its shards and a replicated one once."""
    from repro_torch.models.layers import COMPUTE_DTYPE
    from repro_torch.models.model import chunked_cross_entropy
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 24, 16), generator=g).to(COMPUTE_DTYPE)
    head = torch.randn((16, 48), generator=g)
    labels = torch.randint(0, 40, (2, 24), generator=g)
    mask = (torch.rand((2, 24), generator=g) < 0.8).float()
    logits = torch.randn((5, 48), generator=g)
    logits[0, [5, 40]] = 9.0          # a tie across the shards
    logits[1, [30, 31]] = 9.0         # a tie inside one shard
    logits[2] = 1.0                   # every column the max
    logits[3, 47] = 9.0               # the max in the last shard
    xg, hg = x.clone().requires_grad_(), head.clone().requires_grad_()
    want = chunked_cross_entropy(xg, hg, labels, mask, chunk=8,
                                 valid_vocab=40)
    wdx, wdh = torch.autograd.grad(want, (xg, hg))
    want = want.detach()
    out = _torch_ranks.run_ranks(_torch_ranks.vocab_rank, world, tmp_path,
                                 x, head, labels, mask, logits)
    assert [r["hi"] - r["lo"] for r in out] == [48 // world] * world
    for r in out:
        assert r["repeats"] == {}
        assert float(r["ce"]) == pytest.approx(float(want), rel=CE_REL)
        for got, w in ((r["dx"], wdx), (r["dhead"], wdh[:, r["lo"]:r["hi"]])):
            err = float((got.float() - w.float()).abs().max())
            assert err <= GRAD_BAR * float(w.float().abs().max())
        assert torch.equal(r["argmax"], torch.argmax(logits, -1))
        assert r["remat_in_a_thread"]
        got, want_norm = r["global_norm"]
        assert got == pytest.approx(want_norm, rel=CE_REL)


class _ModelAxis:
    """A duck-typed (1, m) ``DeviceMesh`` seen from model rank ``i``."""
    mesh_dim_names = ("data", "model")

    def __init__(self, m, i):
        self.shape, self.i = (1, m), i

    def size(self, d=None):
        return self.shape[0] * self.shape[1] if d is None else self.shape[d]

    def get_local_rank(self, name):
        return self.i if name == "model" else 0

    def get_group(self, name):
        return name


@pytest.mark.parametrize("m,want", [
    (2, [(0, 3, 0, 1), (3, 6, 1, 2)]),        # each rank one kv group
    (6, [(h, h + 1, h // 3, h // 3 + 1) for h in range(6)]),  # inside one
    (3, [(0, 6, 0, 2)] * 3)])                  # two heads straddle groups
def test_local_heads_keep_the_kernels_grouping(m, want):
    """6 query heads over 2 kv heads: a split whose ranks hold whole kv
    groups, or lie inside one, is taken; one whose local heads straddle
    two groups (m = 3: heads 2 and 3) repeats, counted, with every head
    on every rank."""
    import dataclasses

    from repro_torch import partition
    from repro_torch.models.attention import local_heads
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(),
                              n_heads=6, n_kv_heads=2)
    got = []
    for i in range(m):
        rules = partition.fsdp_rules(_ModelAxis(m, i), 2)
        with partition.use_rules(rules):
            share, klo, khi = local_heads(cfg)
        got.append((share.lo, share.hi, klo, khi))
        assert share.split == (m != 3)
        assert rules.repeats == ({} if share.split else {"attention": 1})
    assert got == want

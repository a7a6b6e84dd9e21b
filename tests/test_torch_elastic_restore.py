"""The port's sharded training state on gloo ranks on the CPU: twin of
``tests/test_dryrun_integration.py::test_elastic_restore_across_topologies``
(a ``TrainState`` saved on a (2, 2) mesh and restored onto (4, 1)), and
the data-parallel train step of every family against the one-process
step.

Bars: the sharded init, the save and every restore are bit-equal (the
whole parameters are built from the seed, then distributed; a checkpoint
holds whole tensors).  The data-parallel steps keep
``tests/test_torch_train.py``'s bars: loss within rel 2e-3, grad norm
within rel 2e-2, each gradient leaf the step hands the optimizer at cosine
>= 0.99 with the one-process step's and its norm within rel 2e-2, and so
each parameter's change (the ranks sum bfloat16 partial gradients of the
gathered weights where one process has one).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_ranks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402

LOSS_REL, LEAF_COS = 2e-3, 0.99


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / max(float(a.norm() * b.norm()), 1e-300))


def test_elastic_restore_across_topologies(tmp_path):
    out = _torch_ranks.run_ranks(_torch_ranks.elastic_rank, 4,
                                 tmp_path / "ranks", str(tmp_path / "ck"))
    for r in out:
        assert r["init_equal"], "sharded init differs from the plain init"
        assert any("Shard" in p for p in r["sharded"])
        assert r["restored_equal"] and r["step"] == 3
        assert r["placed"] == r["want_placed"]
        assert r["plain_onto_mesh_equal"] and r["step_plain"] == 5
        assert r["mesh_onto_plain_equal"]


# (arch, rows, mesh): every family on (2, 1); moe at 8 rows of 64 tokens,
# so that each rank's 256 tokens are one routing group, as in the whole
# batch.  On (2, 2) the model axis replicates each batch shard: the step
# must still average over the two shards, not the four ranks' losses.
TRAINED = (("h2o-danube-1.8b", 4, (2, 1)), ("mamba2-370m", 4, (2, 1)),
           ("moonshot-v1-16b-a3b", 8, (2, 1)),
           ("recurrentgemma-2b", 4, (2, 1)), ("whisper-base", 4, (2, 1)),
           ("internvl2-2b", 4, (2, 1)), ("h2o-danube-1.8b", 4, (2, 2)),
           ("moonshot-v1-16b-a3b", 8, (2, 2)))


@pytest.mark.parametrize("arch,rows,mesh", TRAINED, ids=[
    f"{arch}-{m[0]}x{m[1]}" for arch, _, m in TRAINED])
def test_two_rank_train_step_matches_one_process(arch, rows, mesh, tmp_path):
    """Two steps, so the second's gradients are taken at parameters the
    first update moved.  Each gradient ``make_train_step`` hands the
    optimizer is held to the one-process step's by cosine and by norm (the
    norm at the grad-norm bar, 2e-2)."""
    cfg = get_config(arch).reduced()
    data = SyntheticLMData.for_config(cfg, 64, rows, seed=0, mode="succ")
    batches = [{k: np.asarray(v) for k, v in data.batch(i).items()}
               for i in range(2)]
    out = _torch_ranks.run_ranks(_torch_ranks.train_rank, mesh[0] * mesh[1],
                                 tmp_path, arch, batches, mesh[0])
    for r in out:
        metrics, grads, deltas = r["one"]
        s_metrics, s_grads, s_deltas = r["sharded"]
        for (s_loss, s_gnorm), (loss, gnorm) in zip(s_metrics, metrics):
            assert abs(s_loss - loss) <= LOSS_REL * abs(loss)
            assert abs(s_gnorm - gnorm) <= 2e-2 * gnorm
        assert len(s_grads) == len(grads) == 2
        for s_step, step in zip(s_grads, grads):
            assert len(s_step) == len(step) == len(deltas)
            for a, b in zip(s_step, step):
                assert _cos(a, b) >= LEAF_COS
                na, nb = float(a.double().norm()), float(b.double().norm())
                assert abs(na - nb) <= 2e-2 * nb
        for a, b in zip(s_deltas, deltas):
            assert _cos(a, b) >= LEAF_COS
    assert all(r["sharded"][0] == out[0]["sharded"][0] for r in out)

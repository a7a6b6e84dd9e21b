"""The port's serving launcher on the CPU: the command line serves every
request its token budget for every family, ``Server`` keeps the device
policy and feeds the vlm and encdec stubs zeros as the JAX ``Server.run``
does, and the presets are the JAX package's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.launch.train import preset_config as rpreset_config  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import flash_attention, ssd_scan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402


@pytest.mark.parametrize("arch", ["mamba2-370m", "h2o-danube-1.8b",
                                  "moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b",
                                  "recurrentgemma-2b", "whisper-base",
                                  "internvl2-2b"])
def test_main_serves_every_request(arch, capsys):
    stats = serve.main(["--arch", arch, "--preset", "smoke", "--device",
                        "cpu", "--requests", "3", "--prompt-len", "20",
                        "--gen", "5"])
    assert stats["new_tokens"] == 3 * 5
    assert stats["logits_finite"]
    assert stats["prefill_s"] > 0 and stats["tok_per_s"] > 0
    assert f'"arch": "{arch}-smoke"' in capsys.readouterr().out


def test_server_run_is_greedy_and_counts_no_launch():
    cfg = serve.preset_config("h2o-danube-1.8b", "smoke")
    model = Model(cfg, device="cpu")
    params = model.init(0)
    before = (flash_attention.flash_attention_cuda.launches,
              ssd_scan.ssd_scan_cuda.launches)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (7, 10)]
    srv = serve.Server(model, params, 2, max_seq=24, device="cpu")
    reqs = [serve.Request(rid=i, prompt=p, max_new=4)
            for i, p in enumerate(prompts)]
    stats = srv.run(reqs)
    assert stats["new_tokens"] == 8 and all(len(r.out) == 4 for r in reqs)
    # The first new token is the argmax of the left-padded prefill.
    toks = np.zeros((2, 10), np.int64)
    toks[0, 3:], toks[1] = prompts
    logits, _ = model.prefill(srv.params, {"tokens": torch.from_numpy(toks)},
                              max_seq=24)
    assert [r.out[0] for r in reqs] == torch.argmax(logits, -1).tolist()
    assert (flash_attention.flash_attention_cuda.launches,
            ssd_scan.ssd_scan_cuda.launches) == before


@pytest.mark.parametrize("arch,key,shape", [
    ("internvl2-2b", "patch_embeds", ("n_patches", "d_model")),
    ("whisper-base", "frames", ("n_frames", "d_model"))])
def test_prompt_batch_feeds_zero_stubs(arch, key, shape):
    cfg = serve.preset_config(arch, "smoke")
    tokens = torch.ones((3, 20), dtype=torch.int64)
    batch = serve.prompt_batch(cfg, tokens)
    assert set(batch) == {"tokens", key}
    want = (3,) + tuple(getattr(cfg, f) for f in shape)
    assert tuple(batch[key].shape) == want
    assert batch[key].dtype == torch.bfloat16 and not batch[key].any()
    assert set(serve.prompt_batch(serve.preset_config("h2o-danube-1.8b",
                                                      "smoke"), tokens)) \
        == {"tokens"}


def test_server_refuses_more_requests_than_slots():
    cfg = serve.preset_config("mamba2-370m", "smoke")
    model = Model(cfg, device="cpu")
    srv = serve.Server(model, model.init(0), 1, max_seq=16, device="cpu")
    reqs = [serve.Request(rid=i, prompt=np.ones(4, np.int64), max_new=1)
            for i in range(2)]
    with pytest.raises(ValueError, match="slots"):
        srv.run(reqs)


def test_server_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = serve.preset_config("mamba2-370m", "smoke")
    model = Model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.Server(model, model.init(0), 2, max_seq=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "mamba2-370m", "--preset", "smoke"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("preset", ["smoke", "100m", "full"])
def test_presets_are_the_references(arch, preset):
    """The JAX package's presets, field for field, with the port's own
    fields at their neutral values."""
    from repro_torch.models.config import PORT_FIELDS
    mine = dataclasses.asdict(serve.preset_config(arch, preset))
    assert {k: mine.pop(k) for k in PORT_FIELDS} == PORT_FIELDS
    assert mine == dataclasses.asdict(rpreset_config(arch, preset))

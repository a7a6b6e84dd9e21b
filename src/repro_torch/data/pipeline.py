"""Deterministic sharded synthetic data pipeline.

A copy of the JAX package's ``data/pipeline.py`` (numpy only, so the port
keeps its own): the same seeds give the same batches, bit for bit.

Every batch is a pure function of ``(seed, step, row)`` — restarts replay
the exact same stream regardless of how many steps were lost, and any data
shard can be regenerated independently on its host (the multi-host story:
each host materializes only the rows its data shard owns).

Two task distributions:

* ``mode="zipf"``  — Zipf-distributed tokens (realistic marginals),
* ``mode="copy"``  — the second half of each row repeats the first half
  (induction-head task; needs hundreds of steps to click),
* ``mode="succ"``  — noisy successor chains (x_{t+1} = x_t + 1 mod V with
  5% noise): learnable by the embedding/head alone, so loss falls well
  below the unigram floor within tens of CPU steps — the fast-feedback
  signal for the examples and trainer tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mode: str = "copy"          # "copy" | "zipf"
    zipf_a: float = 1.2
    # modality extras (stub frontends)
    n_patches: int = 0
    n_frames: int = 0
    d_model: int = 0

    def _rows(self, step: int, lo: int, hi: int) -> np.ndarray:
        out = np.empty((hi - lo, self.seq_len + 1), np.int32)
        for i, row in enumerate(range(lo, hi)):
            rng = np.random.default_rng(
                np.uint64(self.seed) * np.uint64(1_000_003)
                + np.uint64(step) * np.uint64(65_537) + np.uint64(row))
            if self.mode == "zipf":
                toks = rng.zipf(self.zipf_a, self.seq_len + 1)
                out[i] = np.minimum(toks, self.vocab_size - 1)
            elif self.mode == "succ":
                start = rng.integers(0, self.vocab_size)
                seq = (start + np.arange(self.seq_len + 1)) % self.vocab_size
                noise = rng.random(self.seq_len + 1) < 0.05
                seq = np.where(noise, rng.integers(
                    0, self.vocab_size, self.seq_len + 1), seq)
                out[i] = seq
            else:
                half = (self.seq_len + 1 + 1) // 2
                first = rng.integers(1, self.vocab_size,
                                     half).astype(np.int32)
                row_t = np.concatenate([first, first])[: self.seq_len + 1]
                out[i] = row_t
        return out

    def batch(self, step: int, shard: int = 0, n_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        """The (full or per-shard) batch for ``step``.

        ``shard``/``n_shards`` select a contiguous row range — the rows a
        data shard owns; the same (step, row) always yields the same data.
        """
        if self.global_batch % n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {n_shards} shards")
        rows = self.global_batch // n_shards
        lo = shard * rows
        seqs = self._rows(step, lo, lo + rows)
        out = {"tokens": seqs[:, :-1].copy(), "labels": seqs[:, 1:].copy()}
        if self.n_patches:
            rng = np.random.default_rng(np.uint64(self.seed + 7) +
                                        np.uint64(step))
            out["patch_embeds"] = rng.standard_normal(
                (rows, self.n_patches, self.d_model)).astype(np.float32) * 0.02
        if self.n_frames:
            rng = np.random.default_rng(np.uint64(self.seed + 13) +
                                        np.uint64(step))
            out["frames"] = rng.standard_normal(
                (rows, self.n_frames, self.d_model)).astype(np.float32) * 0.02
        return out

    @staticmethod
    def for_config(cfg, seq_len: int, global_batch: int, seed: int = 0,
                   mode: str = "copy") -> "SyntheticLMData":
        return SyntheticLMData(
            vocab_size=cfg.vocab_size, seq_len=seq_len,
            global_batch=global_batch, seed=seed, mode=mode,
            n_patches=cfg.n_patches if cfg.family == "vlm" else 0,
            n_frames=cfg.n_frames if cfg.family == "encdec" else 0,
            d_model=cfg.d_model)

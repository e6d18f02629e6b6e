"""Synthetic token stream (counterpart of ``repro.train.data``).

A copy of the reference's LCG grammar: every (step, sample) cell is a pure
function of the seed, drawn with numpy exactly as the reference draws it,
so both packages train on the same tokens bit for bit.  The reference
materialises each host's shard of the global batch on its mesh; on one
device :meth:`SyntheticDataset.batch` returns the whole batch as tensors
on that device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import not_ported
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.dist import Dist


def _lcg_tokens(seed: int, b: int, s: int, vocab: int,
                rule_seed: int = 1234) -> np.ndarray:
    """LCG chains with a *global* transition rule (same (a, c) across steps,
    random start tokens): next = (a·cur + c) mod vocab.  A bigram-learnable
    deterministic grammar, so training loss demonstrably decreases."""
    rr = np.random.RandomState(rule_seed)
    a = int(rr.randint(1, 64)) * 2 + 1
    c = int(rr.randint(0, vocab))
    rng = np.random.RandomState(seed)
    toks = np.empty((b, s), np.int64)
    toks[:, 0] = rng.randint(0, vocab, size=b)
    for t in range(1, s):
        toks[:, t] = (a * toks[:, t - 1] + c) % vocab
    return toks.astype(np.int32)


@dataclass
class SyntheticDataset:
    cfg: ModelConfig
    shape: ShapeConfig
    dist: Dist
    seed: int = 0

    def _host_batch(self, step: int) -> dict[str, np.ndarray]:
        if self.cfg.frontend or self.cfg.n_enc_layers:
            raise not_ported("frontend and encoder batch stubs", "A6")
        b, s = self.shape.global_batch, self.shape.seq_len
        toks = _lcg_tokens(self.seed * 100_003 + step, b, s + 1,
                           self.cfg.vocab_size)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        """This step's batch on ``dist.device`` (int64 token ids)."""
        return {name: torch.from_numpy(np.ascontiguousarray(arr)).to(
                    self.dist.device, dtype=torch.int64)
                for name, arr in self._host_batch(step).items()}

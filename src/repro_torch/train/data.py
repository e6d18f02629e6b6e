"""Synthetic token stream (counterpart of ``repro.train.data``).

A copy of the reference's LCG grammar: every (step, sample) cell is a pure
function of the seed, drawn with numpy exactly as the reference draws it,
so both packages train on the same tokens bit for bit.  The modality
stubs are the reference's too: a vision-prefixed model's batch carries
``prefix_embeds`` and an encoder-decoder's ``enc_embeds``
(:func:`stub_embeds`, the same seeds and values).  The reference
materialises each device's shard of the global batch by its
``batch_specs``; :meth:`SyntheticDataset.batch` returns this rank's part
(its rows over ``pod`` and ``data``, its sequence block over the ring
under ``tatp``: ``train_loop.shard_batch``) as tensors on its device, the
whole batch on one device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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


def stub_embeds(rng: np.random.RandomState, shape, dtype: str) -> np.ndarray:
    """Precomputed frontend embeddings as the reference draws them:
    ``rng.randn(*shape).astype(dtype) * 0.02``, the product in fp32 (numpy
    promotes a bfloat16 array times a Python float to fp32).  The bf16
    rounding goes through torch, whose float64 -> bfloat16 cast rounds to
    nearest even as the reference's numpy bfloat16 does."""
    x = rng.randn(*shape)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    else:
        x = x.astype(dtype)
    return x * np.float32(0.02)


def stub_inputs(cfg: ModelConfig, batch: int, rng_of) -> dict:
    """The stub frontend inputs ``cfg`` takes, by name, in the reference's
    order: a vision-prefixed model's ``prefix_embeds`` and an
    encoder-decoder's ``enc_embeds``, each ``[batch, frontend_tokens,
    d_model]`` drawn by :func:`stub_embeds` from ``rng_of(name)``."""
    names = []
    if cfg.frontend and cfg.family != "encdec":
        names.append("prefix_embeds")
    if cfg.n_enc_layers:
        names.append("enc_embeds")
    shape = (batch, cfg.frontend_tokens, cfg.d_model)
    return {name: stub_embeds(rng_of(name), shape, cfg.dtype)
            for name in names}


@dataclass
class SyntheticDataset:
    cfg: ModelConfig
    shape: ShapeConfig
    dist: Dist
    seed: int = 0
    strategy: str = "tatp"  # megatron replicates the sequence over model

    def _host_batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        b, s = self.shape.global_batch, self.shape.seq_len
        toks = _lcg_tokens(self.seed * 100_003 + step, b, s + 1,
                           cfg.vocab_size)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        # the prefix from RandomState(seed + step + 1), the frames from + 2
        out.update(stub_inputs(cfg, b, lambda name: np.random.RandomState(
            self.seed + step + (1 if name == "prefix_embeds" else 2))))
        return out

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        """This rank's part of this step's batch on ``dist.device``: int64
        token ids, the stub embeddings in fp32 as the reference's host
        batch holds them (the model casts them to its dtype)."""
        from repro_torch.train.train_loop import shard_batch

        part = shard_batch(self.cfg, self._host_batch(step), self.dist,
                           self.strategy)
        return {name: torch.from_numpy(np.ascontiguousarray(arr)).to(
                    self.dist.device,
                    dtype=torch.float32 if arr.dtype.kind == "f"
                    else torch.int64)
                for name, arr in part.items()}

"""Deterministic synthetic token pipeline with Crystal-powered filtering.

Determinism & fault tolerance: every batch is a pure function of
(seed, step, data_shard), so a restarted job resumes mid-stream exactly
(no persisted iterator state — the checkpoint step IS the cursor).

Crystal integration: document quality filtering runs through the same
selection scan the SQL path uses — scores are scanned against the quality
band and the surviving doc ids compacted — so on the card every batch
launches the hand-written ``select_scan`` kernel.

Draws: on the host, from ``np.random.default_rng([seed, step, shard,
k])``, one stream per ``fold_in`` of the reference (k = 0 docs, 1 scores,
2 ``patch_embeds``, 3 ``frames``), so the card and the host give the same
batch.  They are not ``jax.random``'s bits; ``assemble`` takes any draws,
so the filter and the wrap are held to the reference on its own draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models.layers import cdtype


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq: int = 128
    quality_lo: float = 0.2   # crystal selection band on doc quality
    quality_hi: float = 1.0
    pool_factor: int = 2      # oversample pool before quality filtering


class TokenPipeline:
    """Yields model-ready batches; shard-aware and step-addressable."""

    def __init__(self, cfg: ModelConfig, data: DataConfig,
                 shard: int = 0, n_shards: int = 1):
        self.cfg = cfg
        self.data = data
        self.shard = shard
        self.n_shards = n_shards

    def draw(self, step: int):
        """The host draws of ``step`` -> (docs (pool, seq) int32, scores
        (pool,) f32, extras: the frontend's f32 inputs by batch key)."""
        d, cfg = self.data, self.cfg
        rng = lambda k: np.random.default_rng([d.seed, step, self.shard, k])
        pool = d.batch * d.pool_factor
        docs = rng(0).integers(0, cfg.vocab_size, (pool, d.seq),
                               dtype=np.int32)
        scores = rng(1).random(pool, dtype=np.float32)
        extras = {}
        if cfg.family == "vlm":
            extras["patch_embeds"] = rng(2).standard_normal(
                (d.batch, cfg.n_frontend_tokens, cfg.d_model),
                dtype=np.float32)
        if cfg.family == "audio":
            extras["frames"] = rng(3).standard_normal(
                (d.batch, cfg.encoder_len, cfg.d_model), dtype=np.float32)
        return docs, scores, extras

    def assemble(self, docs: np.ndarray, scores: np.ndarray,
                 extras: Dict[str, np.ndarray], device=None
                 ) -> Dict[str, torch.Tensor]:
        """The batch from its draws, on ``device`` (the card when None):
        the docs whose score lies in the quality band, compacted by
        ``ops.select_scan``, wrapped round to fill the batch; the count
        stays on the device."""
        d = self.data
        dev = resolve(device)
        docs_t = torch.tensor(np.asarray(docs, np.int32), device=dev)
        scores_t = torch.tensor(np.asarray(scores, np.float32), device=dev)
        doc_ids = torch.arange(scores_t.shape[0], dtype=torch.int32,
                               device=dev)
        kept, count = ops.select_scan(scores_t, doc_ids, d.quality_lo,
                                      d.quality_hi)
        idx = kept[torch.arange(d.batch, device=dev)
                   % torch.clamp(count, min=1)]
        batch = {"tokens": docs_t[idx.long()]}
        for k, v in extras.items():
            batch[k] = torch.tensor(np.asarray(v, np.float32),
                                    device=dev).to(cdtype(self.cfg))
        return batch

    def batch_at(self, step: int, device=None) -> Dict[str, torch.Tensor]:
        return self.assemble(*self.draw(step), device=device)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

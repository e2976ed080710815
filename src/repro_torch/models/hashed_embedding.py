"""CabinEmbed: hashed vocabulary embeddings built on the paper's hashes,
after the JAX package's `repro.models.hashed_embedding`.

Token ids are categorical values.  The attribute map pi gives k bucket
assignments per id (seeds 811 + j) and a Rademacher hash a sign per id
and repetition (seeds 911 + j):

    embed(t) = (1/sqrt(k)) * sum_j sign_j(t) * table[pi_j(t)]

so a (V, D) table shrinks to (n_buckets, D).  The tied output head is the
transposed trick: y = x @ table^T (B, S, n_buckets), then
logits[t] = (1/sqrt(k)) * sum_j sign_j(t) * y[pi_j(t)].
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hashing
from repro_torch.models.layers import dt, embed_init, matmul


def _bucket_and_sign(cfg: ModelConfig, token_ids: torch.Tensor, j: int):
    t = token_ids.to(torch.int64)
    bucket = hashing.pi_buckets(t, cfg.hashed_embedding_buckets,
                                seed=811 + j)
    sign = hashing.rademacher(t, seed=911 + j)
    return bucket.to(torch.int64), sign


@functools.lru_cache(maxsize=8)
def _vocab_maps(cfg: ModelConfig, device: torch.device) -> tuple:
    """Every id's (bucket, sign) per repetition, built once per config and
    device; callers must not write to them."""
    vocab = torch.arange(cfg.vocab_size, dtype=torch.int64, device=device)
    return tuple(_bucket_and_sign(cfg, vocab, j)
                 for j in range(cfg.hashed_embedding_k))


def hashed_embed_init(cfg: ModelConfig, gen: torch.Generator, device
                      ) -> dict:
    """{"table": (n_buckets, d_model)} of N(0, 0.02) in the param dtype."""
    return {"table": embed_init(gen, cfg.hashed_embedding_buckets,
                                cfg.d_model, dt(cfg.precision.param_dtype),
                                device)}


def hashed_embed(cfg: ModelConfig, params: dict, token_ids: torch.Tensor
                 ) -> torch.Tensor:
    """token_ids (B, S) -> embeddings (B, S, D) in the table's dtype,
    summed in float32."""
    table = params["table"]
    out = None
    for j in range(cfg.hashed_embedding_k):
        bucket, sign = _bucket_and_sign(cfg, token_ids, j)
        e = table[bucket].to(torch.float32) * sign[..., None]
        out = e if out is None else out + e
    return (out / (cfg.hashed_embedding_k ** 0.5)).to(table.dtype)


def hashed_logits(cfg: ModelConfig, params: dict, x: torch.Tensor
                  ) -> torch.Tensor:
    """Tied output head: x (B, S, D) -> logits (B, S, V) float32."""
    y = matmul(x, params["table"].t(), dt(cfg.precision.compute_dtype))
    logits = None
    for bucket, sign in _vocab_maps(cfg, x.device):
        lj = y.index_select(-1, bucket) * sign
        logits = lj if logits is None else logits + lj
    return logits / (cfg.hashed_embedding_k ** 0.5)

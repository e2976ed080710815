"""LM serving engine, after the JAX package's `repro.serve.engine`: batched
prefill, then one decode step per new token against the caches.

`make_serve_step(cfg)` builds the one-token step (params, caches,
tokens (B, 1), pos) -> (logits, caches).  `ServeEngine.generate` runs the
request loop on top: greedy (argmax, the first maximum on a tie, as
jnp.argmax) or temperature sampling.  Sampling draws from a
`torch.Generator` seeded by `seed`, so it cannot repeat the JAX package's
stream for the same seed; greedy tokens can be held against it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, caches, tokens, pos):
        return T.decode_step(cfg, params, caches, tokens, pos)

    return serve_step


@dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, n_generated)
    steps: int
    prefill_s: float  # host seconds from the call to the first token
    decode_s: float  # host seconds of the decode steps after it
    # with keep_logits: the prompt's logits (B, S, V) and the logits each
    # new token was chosen from (B, n_generated, V), the first of them the
    # prompt's last position
    prefill_logits: torch.Tensor | None = None
    step_logits: torch.Tensor | None = None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict,
                 pcfg: ParallelConfig = ParallelConfig(), device="cuda"):
        self.device = resolve_device(device)
        embed = "hashed_embed" if cfg.hashed_embedding else "embed"
        table = params[embed]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"parameters lie on {table.device}, the engine "
                             f"serves on {self.device}")
        self.cfg, self.pcfg, self.params = cfg, pcfg, params
        self.step_fn = make_serve_step(cfg)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts, max_new: int, max_len: int,
                 temperature: float = 0.0, seed: int = 0,
                 keep_logits: bool = False) -> GenerationResult:
        """prompts: (B, S) int token ids (one length per batch), a tensor or
        an array.  Generates `max_new` tokens per request; the caches hold
        `max_len` positions, which must cover S + max_new."""
        tokens = torch.as_tensor(prompts).to(self.device, torch.int32)
        b, s = tokens.shape
        if s + max_new > max_len:
            raise ValueError(f"prompt length {s} + max_new {max_new} exceeds "
                             f"max_len {max_len}")
        gen = None
        if temperature > 0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        self._sync()
        t0 = time.perf_counter()
        logits, caches = T.prefill(self.cfg, self.params, {"tokens": tokens},
                                   max_len, self.pcfg,
                                   self.pcfg.kv_cache_dtype)
        last = logits[:, -1, :]
        if not keep_logits:
            logits = None
        out, kept = [], []
        t_first = None
        for i in range(max_new):
            if keep_logits:
                kept.append(last)
            if temperature > 0:
                probs = torch.softmax(last.float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)
            else:
                tok = torch.argmax(last, dim=-1, keepdim=True)
            tok = tok.to(torch.int32)
            out.append(tok.cpu().numpy())
            if t_first is None:
                t_first = time.perf_counter()
            last = self.step_fn(self.params, caches, tok, s + i)[0][:, 0, :]
        self._sync()
        t_end = time.perf_counter()
        t_first = t_end if t_first is None else t_first
        return GenerationResult(
            tokens=(np.concatenate(out, axis=1) if out
                    else np.zeros((b, 0), np.int32)),
            steps=max_new, prefill_s=t_first - t0, decode_s=t_end - t_first,
            prefill_logits=logits,
            step_logits=(torch.stack(kept, dim=1) if keep_logits and kept
                         else None))

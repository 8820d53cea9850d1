"""Deterministic synthetic LM data (counterpart of ``repro/data/synthetic.py``).

Every batch is a function of (seed, step) alone. The LM stream is the
reference's "stride induction": tokens follow t_i = (start + i·stride)
mod V with 5% uniform corruption, so the next token is predictable from
any two previous clean tokens. The draws come from a ``torch.Generator``,
so the distribution is the reference's and the bits are not (tests that
need the same batches take them from the reference as numpy arrays).
Encoder (audio) and image-memory batches come with the slices of those
model families; CIFAR batches with the CNN slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import Config
from repro_torch.device import resolve_device


def _step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step) alone."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    return gen


def lm_tokens(generator: torch.Generator, batch: int, seq: int, vocab: int,
              noise: float = 0.05) -> torch.Tensor:
    dev = generator.device
    start = torch.randint(0, vocab, (batch, 1), generator=generator, device=dev)
    stride = torch.randint(1, max(vocab // 4, 2), (batch, 1),
                           generator=generator, device=dev)
    idx = torch.arange(seq, device=dev)[None, :]
    toks = (start + idx * stride) % vocab
    corrupt = torch.rand((batch, seq), generator=generator, device=dev) < noise
    rand = torch.randint(0, vocab, (batch, seq), generator=generator,
                         device=dev)
    return torch.where(corrupt, rand, toks).to(torch.int32)


def lm_batch(cfg: Config, step: int, *, device=None) -> Dict[str, torch.Tensor]:
    """{"tokens": (global_batch, seq_len) int32} for the dense LM, drawn on
    ``device`` (default ``cuda``; raises without it unless ``"cpu"``)."""
    m, t = cfg.model, cfg.train
    if m.is_encoder or m.cross_attn_every:
        raise NotImplementedError(
            "encoder (frame) and image-memory batches come with the audio "
            "and VLM slices of the port (ROADMAP.md, Queue 1)")
    gen = _step_generator(t.seed, step, resolve_device(device))
    return {"tokens": lm_tokens(gen, t.global_batch, t.seq_len, m.vocab_size)}

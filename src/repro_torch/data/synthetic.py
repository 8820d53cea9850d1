"""Deterministic synthetic data (counterpart of ``repro/data/synthetic.py``).

Every batch is a function of (seed, step) alone. The draws come from a
``torch.Generator`` on the batch's device, so the distributions are the
reference's and the bits are not (tests that need the same batches take
them from the reference as numpy arrays).

LM stream: the reference's "stride induction": tokens follow t_i =
(start + i·stride) mod V with 5% uniform corruption, so the next token is
predictable from any two previous clean tokens.

CIFAR stream (the CNN family): a fixed N(0, 1) prototype image per class
plus 1.5·N(0, 1) noise, labels uniform: separable but noisy, so accuracy
climbs as on real data, without a file.

Encoder (audio) and image-memory batches come with the slices of those
model families (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import Config
from repro_torch.device import resolve_device


def _step_generator(seed: int, step: int, device, salt: int = 0
                    ) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step, salt) alone; salt
    0 is the LM stream's, 1 the CIFAR stream's."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)
                     + int(salt) * 0x9E3779B97F4A7C15) % (2 ** 63))
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


_PROTO_CACHE: Dict[tuple, torch.Tensor] = {}
CIFAR_SIGMA = 1.5   # the reference's noise scale around each prototype


def cifar_prototypes(num_classes: int, seed: int = 7, *, device=None
                     ) -> torch.Tensor:
    """(num_classes, 32, 32, 3) N(0, 1) f32 prototype images on ``device``
    (default ``cuda``), drawn once per (classes, seed, device)."""
    dev = resolve_device(device)
    ck = (int(num_classes), int(seed), str(dev))
    if ck not in _PROTO_CACHE:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        _PROTO_CACHE[ck] = torch.randn((num_classes, 32, 32, 3),
                                       generator=gen, device=dev)
    return _PROTO_CACHE[ck]


def cifar_batch(num_classes: int, batch: int, step: int, seed: int = 0, *,
                device=None) -> Dict[str, torch.Tensor]:
    """{"images": (batch, 32, 32, 3) f32 NHWC, "labels": (batch,) int32}
    on ``device`` (default ``cuda``): uniform labels, each image its
    class's prototype plus ``CIFAR_SIGMA``·N(0, 1)."""
    dev = resolve_device(device)
    gen = _step_generator(seed, step, dev, salt=1)
    labels = torch.randint(0, num_classes, (batch,), generator=gen,
                           device=dev, dtype=torch.int32)
    protos = cifar_prototypes(num_classes, device=dev)
    noise = torch.randn((batch, 32, 32, 3), generator=gen, device=dev)
    return {"images": protos[labels.long()] + CIFAR_SIGMA * noise,
            "labels": labels}

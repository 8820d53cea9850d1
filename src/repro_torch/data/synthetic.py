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

Encoder (audio) batches: N(0, 1) frame embeddings, labelled by the argmax
of their first V features; a VLM's batch adds N(0, 1) image-patch
embeddings as its memory (the reference's stub frontends).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import Config
from repro_torch.device import resolve_device


def _step_generator(seed: int, step: int, device, salt: int = 0
                    ) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step, salt) alone; salt
    0 is the LM stream's (tokens, or an encoder's frames), 1 the CIFAR
    stream's, 2 a VLM's image memory."""
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
    """The batch of the LM stack (``synthetic.py:47-62``), drawn on
    ``device`` (default ``cuda``; raises without it unless ``"cpu"``):
    {"tokens": (global_batch, seq_len) int32}, with, for a VLM, "memory":
    (global_batch, num_image_tokens, d_model) f32 N(0, 1); for an encoder
    {"embeds": (global_batch, seq_len, d_model) f32 N(0, 1), "labels":
    the argmax of each frame's first vocab_size features, int32}."""
    m, t = cfg.model, cfg.train
    dev = resolve_device(device)
    gen = _step_generator(t.seed, step, dev)
    if m.is_encoder:
        emb = torch.randn((t.global_batch, t.seq_len, m.d_model),
                          generator=gen, device=dev)
        labels = torch.argmax(emb[..., :m.vocab_size], dim=-1)
        return {"embeds": emb, "labels": labels.to(torch.int32)}
    batch = {"tokens": lm_tokens(gen, t.global_batch, t.seq_len, m.vocab_size)}
    if m.cross_attn_every:
        batch["memory"] = torch.randn(
            (t.global_batch, m.num_image_tokens, m.d_model),
            generator=_step_generator(t.seed, step, dev, salt=2), device=dev)
    return batch


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

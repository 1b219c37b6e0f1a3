"""The four assigned input-shape suites (applied per architecture); a copy
of ``repro.configs.shapes``.

train_4k    -> train_step      (seq 4096,   global batch 256)
prefill_32k -> prefill_step    (seq 32768,  global batch 32)
decode_32k  -> decode_step     (KV cache 32768, global batch 128, 1 new tok)
long_500k   -> decode_step     (KV cache 524288, global batch 1) — only for
               sub-quadratic architectures (SSM / hybrid), per assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeSuite("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSuite("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSuite("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSuite("long_500k", "decode", 524288, 1)

ALL_SHAPES: Tuple[ShapeSuite, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                      LONG_500K)


def get_shape(name: str) -> ShapeSuite:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable_shapes(cfg) -> Tuple[ShapeSuite, ...]:
    """Shape suites that apply to an architecture.

    long_500k runs for SSM/hybrid families (decode cost is linear: bounded
    SSM state + single-token KV reads); pure full-attention archs skip it
    per the assignment.
    """
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.family in ("ssm", "hybrid"):
        shapes.append(LONG_500K)
    return tuple(shapes)

"""Byte-level tokenizer for the LM examples (no external vocab files).
The port's copy of the JAX package's `repro.data.tokenizer` (numpy only).

Reserved ids: 0 = pad, 1 = bos, 2 = eos; bytes map to 3..258.  Any vocab size
>= 259 works (the assigned architectures all have far larger vocabs; the
unused tail of the embedding matrix is exercised by the hashed CabinEmbed
path and by synthetic-token training).
"""

from __future__ import annotations

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_OFFSET = 3
VOCAB_MIN = 256 + _OFFSET


def encode(text: str, add_bos: bool = True, add_eos: bool = True) -> np.ndarray:
    ids = [b + _OFFSET for b in text.encode("utf-8")]
    if add_bos:
        ids = [BOS_ID] + ids
    if add_eos:
        ids = ids + [EOS_ID]
    return np.asarray(ids, dtype=np.int32)


def decode(ids) -> str:
    data = bytes(int(i) - _OFFSET for i in ids
                 if _OFFSET <= int(i) < _OFFSET + 256)
    return data.decode("utf-8", errors="replace")


def pad_or_trim(ids: np.ndarray, length: int) -> np.ndarray:
    out = np.full(length, PAD_ID, dtype=np.int32)
    take = min(length, len(ids))
    out[:take] = ids[:take]
    return out

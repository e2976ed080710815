"""Streaming ingest: document streams -> a live QueryEngine.

The port of the JAX package's `repro.index.ingest`.  Token-id documents
are windowed (`data.pipeline.document_windows`, the dedup filter's
windowing), converted to padded-COO categorical rows (`data.dedup`'s BoW
capping), optionally near-dedup'd WITHIN the window in the engine's own
sketch space, and appended.  The window is sketched once, on the engine's
device, and the same sketches serve the dedup pass and the store append
(`add_packed`), so dedup costs only the candidate scan.

This loop is one sequential writer.  A document's sketch is a pure
function of (document, spec) and everything above the sketches is
Mergeable, so `index.merge_tree.bulk_ingest` runs copies of this loop over
document shards in parallel and tree-merges the private engines into one,
bit-identical to the sequential build with dedup off.
"""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.data import dedup as dedup_mod
from repro_torch.data.pipeline import document_windows
from repro_torch.index.engine import QueryEngine


def ingest_documents(
    engine: QueryEngine,
    docs: Iterable[np.ndarray] | Iterator[np.ndarray],
    *,
    window: int = 512,
    max_docs: int | None = None,
    dedup_threshold: float | None = None,
) -> np.ndarray:
    """Stream token-id documents into `engine`; returns one entry per
    consumed document: its assigned id, or -1 if the in-window dedup pass
    dropped it as a near-duplicate (dedup_threshold=None keeps everything).

    The engine's CabinParams.n_dims is the vocabulary size: token counts
    (capped, BoW-style) are the categorical values, exactly as the dedup
    pipeline stage treats documents.
    """
    vocab = engine.params.n_dims
    out: list[np.ndarray] = []
    stream = iter(docs)
    if max_docs is not None:
        # cap BEFORE windowing so no document is pulled from the caller's
        # iterator without getting an output entry
        stream = itertools.islice(stream, max_docs)
    for win in document_windows(stream, window):
        idx, val = dedup_mod.docs_to_categorical(win, vocab)
        if dedup_threshold is None:
            out.append(engine.add_sparse(idx, val))
            continue
        sk, k = engine._sketch((idx, val))
        sk = sk[:k]
        # dedup in the ENGINE's metric so the threshold shares units with
        # every distance the engine serves
        result = dedup_mod.dedup_by_sketch(
            sk, engine.d, dedup_threshold, metric=engine.metric,
            device=engine.device)
        ids = np.full(len(win), -1, np.int64)
        keep = result.keep_mask
        if keep.any():
            # the kept rows' raw COO goes along with their sketches, so the
            # archive keeps them re-sketchable (and mid-migration they are
            # re-sketched into the new-spec tier)
            ids[keep] = engine.add_packed(
                sk[torch.from_numpy(keep).to(sk.device)],
                raw=(idx[keep], val[keep]))
        out.append(ids)
    if not out:
        return np.zeros(0, np.int64)
    return np.concatenate(out)

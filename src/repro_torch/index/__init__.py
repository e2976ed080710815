"""Online similarity serving of the PyTorch port, after the JAX package's
`repro.index`: store, banded layout, partitions, the query engine, the
Mergeable contract, the spec migration, streaming document ingest and the
merge-tree bulk load."""

from repro_torch.index.bands import BandedLayout  # noqa: F401
from repro_torch.index.engine import QueryEngine  # noqa: F401
from repro_torch.index.ingest import ingest_documents  # noqa: F401
from repro_torch.index.merge_tree import bulk_ingest, merge_tree  # noqa: F401
from repro_torch.index.mergeable import (Mergeable,  # noqa: F401
                                         MergeIncompatible, check_id_disjoint,
                                         check_spec_compatible)
from repro_torch.index.migrate import Migration, RawArchive  # noqa: F401
from repro_torch.index.partition import (Partition, PartitionSet,  # noqa: F401
                                         TieredLayout, merge_topk_parts)
from repro_torch.index.store import SketchSpec, SketchStore  # noqa: F401

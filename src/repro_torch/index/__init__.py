"""Online similarity serving of the PyTorch port, after the JAX package's
`repro.index`: store, banded layout, partitions and the query engine."""

from repro_torch.index.bands import BandedLayout  # noqa: F401
from repro_torch.index.engine import QueryEngine  # noqa: F401
from repro_torch.index.partition import (PartitionSet,  # noqa: F401
                                         merge_topk_parts)
from repro_torch.index.store import SketchSpec, SketchStore  # noqa: F401

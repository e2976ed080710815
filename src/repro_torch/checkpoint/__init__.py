"""Checkpointing of the PyTorch port (`checkpointer.Checkpointer`)."""

from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    CheckpointCorruptError, Checkpointer, flat_to_tree, tree_to_flat)

"""Data substrate of the PyTorch port, after the JAX package's `repro.data`:
synthetic categorical data, the byte tokenizer, corpus dedup over Cabin
sketches and the LM batch pipeline."""

"""The LM stack of the port, after the JAX package's `repro.models`: the
dense GQA family (attention + SwiGLU MLP decoder layers)."""

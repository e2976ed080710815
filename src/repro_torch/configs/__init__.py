"""Model configurations of the port, after the JAX package's
`repro.configs`: the dense GQA family (attention + dense MLP)."""

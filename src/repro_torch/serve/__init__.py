"""LM serving of the port, after the JAX package's `repro.serve.engine`."""

from repro_torch.serve.engine import (GenerationResult,  # noqa: F401
                                      ServeEngine, make_serve_step)

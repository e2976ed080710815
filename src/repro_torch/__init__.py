"""repro_torch: the PyTorch and CUDA port of the BinSketch/Cabin system.

It serves the paper's Cabin -> Cham pipeline on an NVIDIA Hopper card
(sparse or dense categorical rows in, k-NN / radius / pairwise answers
out) and the dense GQA language models of the JAX package (prefill and
cached decode), through hand-written CUDA kernels (`repro_torch.kernels`).
Entry points run on CUDA unless the caller passes device="cpu", where each
kernel's plain PyTorch version takes its place.  The package imports torch
and numpy only.

    from repro_torch.core import CabinParams
    from repro_torch.index import QueryEngine
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeEngine
"""

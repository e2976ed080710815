"""repro_torch: the PyTorch and CUDA port of the BinSketch/Cabin system.

It serves the paper's Cabin -> Cham pipeline on an NVIDIA Hopper card:
sparse categorical rows in, k-NN / radius / pairwise answers out, through
hand-written CUDA kernels (`repro_torch.kernels`).  Entry points run on
CUDA unless the caller passes device="cpu", where each kernel's plain
PyTorch version takes its place.  The package imports torch and numpy
only.

    from repro_torch.core import CabinParams
    from repro_torch.index import QueryEngine
"""

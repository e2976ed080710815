"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

`csrc/` holds the CUDA sources, `build` compiles and loads them, and each
`<name>/ops.py` wraps one kernel beside its plain PyTorch version
(`<name>/ref.py`), which a CPU tensor takes instead of the kernel."""

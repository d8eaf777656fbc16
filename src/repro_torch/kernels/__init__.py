"""Hand-written Hopper kernels (CUDA C++ in ``repro_torch/csrc``) for the
Pallas kernels on the port's path, each beside its plain PyTorch version."""

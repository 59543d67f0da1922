"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``).

Each kernel package holds the wrapper, which launches the kernel for
tensors on the card and counts its launches, and the plain PyTorch version
of the same function, which the wrapper uses for tensors on the CPU."""

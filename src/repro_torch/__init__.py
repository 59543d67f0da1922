"""PyTorch + CUDA port of ``repro`` for an NVIDIA H100 (sm_90a).

The JAX package ``repro`` stays the reference; this package mirrors its
module layout and never imports JAX or ``repro``.  Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``.  The
attention kernels are hand-written CUDA C++ under ``csrc/``, built with
``nvcc`` at first use (:mod:`repro_torch.kernels.build`).
"""

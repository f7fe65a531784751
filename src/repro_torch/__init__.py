"""PyTorch / CUDA port of the Mosaic serving stack for NVIDIA Hopper.

Mirrors the module layout of the JAX reference package ``repro``; imports
none of it (and no JAX).  Plain tensor code is PyTorch; every TPU kernel on
the ported path is a hand-written CUDA kernel under ``csrc/``, built at
first use (``repro_torch.kernels.build``).  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``, where each kernel wrapper runs
its plain PyTorch version instead.
"""

"""Model code of the port: layers, paged KV, the dense decoder stack, LM.

The package imports no submodule itself: :mod:`repro_torch.kernels.ref`
imports ``layers`` and ``paged``, and ``transformer`` imports the kernel
wrappers, so an eager import of ``lm`` here would close an import cycle
through whichever kernel module was imported first.
"""

"""PyTorch/CUDA port of the RemoteRAG reproduction.

Mirrors the JAX package ``repro`` module for module (``repro_torch.X`` is
the counterpart of ``repro.X``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on a CUDA tensor every kernel wrapper
launches its hand-written Hopper kernel, on a CPU tensor it runs the plain
PyTorch version beside it.  Importing this package builds nothing: the
kernels are compiled from ``csrc/`` at their first launch.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

"""Device choice for the port's entry points.

The default is ``cuda``.  A caller that wants the CPU says so with
``device="cpu"``; there is no silent "cuda if available, else cpu"."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (the current CUDA device, with its index);
    raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on cuda by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # the device tensors report: "cuda" and "cuda:0" compare equal after
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


__all__ = ["DeviceLike", "resolve_device"]

"""Build, load and count the port's CUDA kernels.

The kernels in ``repro_torch/csrc/*.cu`` (plain C interfaces, compiled by
``nvcc`` for ``sm_90a``) and their PyTorch bindings in
``csrc/bindings.cpp`` form one extension, built by
``torch.utils.cpp_extension.load`` at the first kernel launch — never at
import — into ``build/torch_ext/`` of the checkout; ninja compiles the
sources in parallel and rebuilds only what changed.  A failed or missing
build raises; nothing falls back to the plain path.

Every wrapper that launches a kernel adds one to its count in
`launch_counts` where it launches, and nowhere else; `launch_shapes`
splits the same counts by the shape the kernel was launched at.
"""

from __future__ import annotations

import collections
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"

SOURCES = ("bindings.cpp", "ntt.cu", "fused.cu", "scoretopk.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3")

_lock = threading.Lock()
_ext = None
_count_lock = threading.Lock()
_launches: collections.Counter = collections.Counter()
_shapes: collections.Counter = collections.Counter()
build_info: dict = {}       # builds started, seconds of the last build


def count_launch(name: str, shape) -> None:
    """One launch of kernel ``name`` at ``shape`` (the kernel's own view of
    its main input, e.g. (batch, N) for the NTT)."""
    # the serving engine's retry lane launches kernels from its own thread
    with _count_lock:
        _launches[name] += 1
        _shapes[(name, tuple(int(d) for d in shape))] += 1


def reset_launches() -> None:
    with _count_lock:
        _launches.clear()
        _shapes.clear()


def launch_counts() -> dict:
    with _count_lock:
        return dict(_launches)


def launch_shapes() -> dict:
    """{(name, shape): launches} since the last `reset_launches`."""
    with _count_lock:
        return dict(_shapes)


def builds_started() -> int:
    """Number of kernel builds this process has started (0 until the first
    launch on a CUDA tensor)."""
    return int(build_info.get("builds", 0))


def extension():
    """The loaded extension module; builds it on first use."""
    global _ext
    if _ext is not None:
        return _ext
    with _lock:
        if _ext is None:
            from torch.utils import cpp_extension

            build_info["builds"] = builds_started() + 1
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            _ext = cpp_extension.load(
                name="repro_torch_kernels",
                sources=[str(CSRC / s) for s in SOURCES],
                extra_cflags=["-O3"], extra_cuda_cflags=list(NVCC_FLAGS),
                build_directory=str(BUILD_DIR))
            build_info["seconds"] = time.perf_counter() - t0
    return _ext


def on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version) or a ``meta`` one (the plain version's shapes: the
    dry run); raises for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"unsupported device {x.device}")


def require_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"kernel wrapper needs CUDA tensors, got {t.device}")


__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "extension", "count_launch",
           "reset_launches", "launch_counts", "launch_shapes",
           "builds_started", "build_info",
           "on_cuda", "require_cuda"]

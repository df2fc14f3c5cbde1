"""The frozen copy's stand-in for the port's kernel loader: it builds and
loads nothing. The reference runs no CUDA kernel (every call it makes takes
a plain PyTorch path, and its closest hits are portbench/reference/
visibility.py's), so a launcher that reaches ``library()`` is a fault."""

from __future__ import annotations

import torch


def library(verbose: bool = False):
    raise RuntimeError("the frozen reference launched a CUDA kernel")


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed ({err})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, shape=None, dtype=torch.float32,
            device=None):
    """Wrapper checks: dtype, contiguity, device and (optionally) shape."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t

"""Constant tensors made once per (values, device, dtype).

A tensor made from host data on the card is a copy that waits for the card,
and one that a CUDA graph cannot capture, so code that runs every tick, or
inside a graph (`runtime/cache.py`), reuses these instead of calling
`torch.tensor`. They are shared: never write to one. The caches are not
bounded: a captured graph reads a constant by its address, so none may be
freed while a graph lives (there is one per value, device and dtype);
`runtime/cache.clear()` empties them with the graphs.
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def device_constant(values: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant_like(values, like: torch.Tensor) -> torch.Tensor:
    """`values` (a float or nested tuples of floats) in the dtype and on the
    device of `like`."""
    return device_constant(values, like.device, like.dtype)


@functools.cache
def _eye(n: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.eye(n, dtype=dtype, device=device)


def eye_like(n: int, like: torch.Tensor) -> torch.Tensor:
    """The n x n identity in the dtype and on the device of `like` (shared)."""
    return _eye(n, like.device, like.dtype)


def tensor_like(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """`torch.as_tensor(x, dtype, like.device)` (dtype defaults to like's)
    that makes no tensor from host data: a tensor is converted, a number or
    nested tuple of numbers is a shared constant."""
    dtype = like.dtype if dtype is None else dtype
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=dtype)
    return device_constant(x, like.device, dtype)


def clear() -> None:
    """Forget every constant (holders keep theirs)."""
    device_constant.cache_clear()
    _eye.cache_clear()

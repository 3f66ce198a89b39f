"""Constant tensors made once per (values, device, dtype).

A tensor made from host data on the card is a copy that waits for the card,
so code that runs every tick reuses these instead of calling `torch.tensor`.
They are shared: never write to one.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=256)
def device_constant(values: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant_like(values, like: torch.Tensor) -> torch.Tensor:
    """`values` (a float or nested tuples of floats) in the dtype and on the
    device of `like`."""
    return device_constant(values, like.device, like.dtype)


@functools.lru_cache(maxsize=64)
def _eye(n: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.eye(n, dtype=dtype, device=device)


def eye_like(n: int, like: torch.Tensor) -> torch.Tensor:
    """The n x n identity in the dtype and on the device of `like` (shared)."""
    return _eye(n, like.device, like.dtype)

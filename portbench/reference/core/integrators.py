"""Fixed-step ODE integrators (RK4 / forward Euler).

PyTorch counterpart of `cmw_tpu/core/integrators.py`. A state is a tensor
or a (named) tuple, list or dict of them; `f(x, *args)` returns a
derivative of the same structure. Pure functions: `step(f, x, dt, *args)`.
"""

from __future__ import annotations

import torch


def _map(fn, x, *rest):
    """Apply fn leaf by leaf over states of the same structure."""
    if isinstance(x, torch.Tensor):
        return fn(x, *rest)
    if isinstance(x, dict):
        return {k: _map(fn, x[k], *(r[k] for r in rest)) for k in x}
    leaves = [_map(fn, *parts) for parts in zip(x, *rest)]
    return type(x)(*leaves) if hasattr(x, "_fields") else type(x)(leaves)


def euler_step(f, x, dt, *args):
    return _map(lambda a, b: a + dt * b, x, f(x, *args))


def rk4_step(f, x, dt, *args):
    k1 = f(x, *args)
    k2 = f(_map(lambda a, b: a + 0.5 * dt * b, x, k1), *args)
    k3 = f(_map(lambda a, b: a + 0.5 * dt * b, x, k2), *args)
    k4 = f(_map(lambda a, b: a + dt * b, x, k3), *args)
    return _map(
        lambda a, b1, b2, b3, b4: a + (dt / 6.0) * (b1 + 2.0 * b2 + 2.0 * b3 + b4),
        x,
        k1,
        k2,
        k3,
        k4,
    )

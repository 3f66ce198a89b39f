"""Port parity for `cmw_tpu_torch.core.{lie, splines, integrators}` vs
`cmw_tpu.core`: the same numpy inputs through `jax.vmap` of the JAX function
and the port's batched one, in float64 (JAX under enable_x64) and float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.core import integrators as jint
from cmw_tpu.core import lie as jlie
from cmw_tpu.core import splines as jspl
from cmw_tpu_torch.core import integrators as tint
from cmw_tpu_torch.core import lie as tlie
from cmw_tpu_torch.core import splines as tspl

torch.set_num_threads(2)

# f64: the same formulas, sums in another order; f32: a few ulps of O(1) values
TOL = {"f64": 1e-12, "f32": 2e-6}
DTYPES = {"f64": (jnp.float64, torch.float64, np.float64), "f32": (jnp.float32, torch.float32, np.float32)}


def _angles(rng):
    """Rotation vectors [24, 3]: random, near zero (inside and just outside
    the series branch), exactly zero, and near pi."""
    axes = rng.standard_normal((24, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    theta = np.concatenate([
        rng.uniform(0.1, 3.0, 12),
        [0.0, 1e-9, 1e-6, 5e-5, 1e-4, 2e-4],  # theta^2 around the series threshold 1e-8
        np.pi - np.array([1e-3, 1e-2, 5e-2, 0.1, 0.2, 0.3]),
    ])
    return axes * theta[:, None]


def _hat(w):
    z = np.zeros(w.shape[:-1])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1), np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _rodrigues(w):
    theta = np.linalg.norm(w, axis=-1)[..., None, None]
    W = _hat(w / np.maximum(theta[..., 0], 1e-300))
    return np.eye(3) + np.sin(theta) * W + (1.0 - np.cos(theta)) * (W @ W)


def _inputs(rng, name):
    w = _angles(rng)
    R = _rodrigues(w)
    p = rng.standard_normal((24, 3))
    q = rng.standard_normal((24, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return {
        "hat": (w,), "vee": (_hat(w),), "so3_exp": (w,),
        "so3_log": (R,), "so3_distance": (R, R[::-1].copy()), "rotz": (w[:, 0] * 3.0,), "yaw_of": (R,),
        "quat_to_mat": (q,), "mat_to_quat": (R,), "quat_mul": (q, q[::-1].copy()),
        "se3_compose": (R, p, R[::-1].copy(), p[::-1].copy()), "se3_inverse": (R, p), "se3_apply": (R, p, p[::-1].copy()),
        "se3_exp": (np.concatenate([p, w], axis=-1),),
        "integrate_mixed_velocity": (R, p, p[::-1].copy(), w, 0.01),
        "project_to_so3": (R + 1e-3 * rng.standard_normal(R.shape),),
    }[name]


LIE = ["hat", "vee", "so3_exp", "so3_log", "so3_distance", "rotz", "yaw_of", "quat_to_mat", "mat_to_quat",
       "quat_mul", "se3_compose", "se3_inverse", "se3_apply", "se3_exp", "integrate_mixed_velocity",
       "project_to_so3"]


def _args(name, dt):
    args = _inputs(np.random.default_rng(0), name)
    if dt == "f32" and name in ("so3_log", "so3_distance", "mat_to_quat"):
        args = tuple(a[:18] if isinstance(a, np.ndarray) else a for a in args)
    return args


@pytest.fixture(scope="module")
def jax_lie():
    """{dtype: {name: JAX outputs}}: every lie function under jax.vmap, in one
    jit per dtype."""
    out = {}
    for dt, (jd, _, _) in DTYPES.items():
        args = {name: _args(name, dt) for name in LIE}

        def run(arrays):
            res = {}
            for name in LIE:
                it = iter(arrays[name])
                call = tuple(next(it) if isinstance(a, np.ndarray) else a for a in args[name])
                axes = tuple(0 if isinstance(a, np.ndarray) else None for a in args[name])
                res[name] = jax.vmap(getattr(jlie, name), in_axes=axes)(*call)
            return res

        with jax.enable_x64(dt == "f64"):
            arrays = {name: [jnp.asarray(a, jd) for a in args[name] if isinstance(a, np.ndarray)] for name in LIE}
            out[dt] = jax.tree_util.tree_map(np.asarray, jax.jit(run)(arrays))
    return out


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", LIE)
def test_lie_matches_jax(jax_lie, name, dt):
    """Every function of lie.py, at random angles and at the series branches'
    edges: theta -> 0 and theta -> pi. The log map's 1/sin(theta) near pi
    turns an f32 ulp into ~1e-3, so f32 is held away from pi."""
    _, td, nd = DTYPES[dt]
    args = _args(name, dt)
    want = jax_lie[dt][name]
    got = getattr(tlie, name)(*(torch.tensor(a.astype(nd)) if isinstance(a, np.ndarray) else a for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == td
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL[dt] * max(1.0, np.abs(w).max()))


def test_project_to_so3_returns_the_polar_factor():
    """U and V of the SVD are not unique, U V^T is: the projection is a
    rotation and fixes an exact one."""
    rng = np.random.default_rng(1)
    R = _rodrigues(_angles(rng)).astype(np.float32)
    P = tlie.project_to_so3(torch.tensor(R) + 1e-2 * torch.randn(R.shape, dtype=torch.float32))
    eye = torch.eye(3).expand_as(P)
    assert float((P @ P.transpose(-1, -2) - eye).abs().max()) < 1e-5
    assert float((torch.linalg.det(P) - 1.0).abs().max()) < 1e-5
    np.testing.assert_allclose(tlie.project_to_so3(torch.tensor(R)).numpy(), R, atol=1e-5)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shared_knots", [True, False])
def test_linear_spline_matches_jax(dt, shared_knots):
    """Queries before, between, on and after the knots; knots shared by the
    batch or one set per item."""
    jd, td, nd = DTYPES[dt]
    rng = np.random.default_rng(2)
    B, K, D = 3, 9, 3
    knots = np.cumsum(rng.uniform(0.02, 0.1, (B, K)), axis=-1)
    if shared_knots:
        knots = np.broadcast_to(knots[0], (B, K)).copy()
    values = rng.standard_normal((B, K, D))
    query = np.concatenate([knots[:, :1] - 0.3, knots[:, :3], rng.uniform(0.0, 1.2, (B, 8)), knots[:, -1:] + 0.5], -1)
    with jax.enable_x64(dt == "f64"):
        want = jax.vmap(jspl.linear_spline)(*(jnp.asarray(a, jd) for a in (knots, values, query)))
    kt = torch.tensor(knots[0].astype(nd)) if shared_knots else torch.tensor(knots.astype(nd))
    got = tspl.linear_spline(kt, torch.tensor(values.astype(nd)), torch.tensor(query.astype(nd)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_quintic_hermite_and_timescale_match_jax(dt):
    """Times before, inside and after the segment, per item."""
    jd, td, nd = DTYPES[dt]
    rng = np.random.default_rng(3)
    B, D = 6, 3
    t0 = rng.uniform(0.0, 1.0, B)
    t1 = t0 + rng.uniform(0.2, 0.8, B)
    t = np.array([t0[0] - 0.1, t0[1], 0.5 * (t0[2] + t1[2]), t1[3], t1[4] + 0.2, 0.3 * t0[5] + 0.7 * t1[5]])
    bc = [rng.standard_normal((B, D)) for _ in range(6)]
    with jax.enable_x64(dt == "f64"):
        want = jax.vmap(jspl.quintic_hermite)(*(jnp.asarray(a, jd) for a in (t, t0, t1, *bc)))
        want_s = jax.vmap(jspl.quintic_timescale)(*(jnp.asarray(a, jd) for a in (t, t0, t1)))
    got = tspl.quintic_hermite(*(torch.tensor(a.astype(nd)) for a in (t, t0, t1, *bc)))
    got_s = tspl.quintic_timescale(*(torch.tensor(a.astype(nd)) for a in (t, t0, t1)))
    for g, w in list(zip(got, want)) + list(zip(got_s, want_s)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=10 * TOL[dt], atol=10 * TOL[dt])
    # float segment bounds, as the swing planner passes them
    p, _, _ = tspl.quintic_hermite(torch.tensor(0.25), 0.0, 0.5, *(torch.tensor(a[0]) for a in bc))
    assert p.shape == (D,)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("method", ["rk4_step", "euler_step"])
def test_integrators_match_jax(method, dt):
    """A tuple state (x [B, 3], (v [B, 3],)) under a non-linear field with an
    extra argument."""
    jd, td, nd = DTYPES[dt]
    rng = np.random.default_rng(4)
    x, v, k = (rng.standard_normal((5, 3)) for _ in range(3))

    def f_jax(s, kk):
        return (s[1][0] * jnp.cos(s[0]), (-kk * s[0] - 0.1 * s[1][0] ** 3,))

    def f_torch(s, kk):
        return (s[1][0] * torch.cos(s[0]), (-kk * s[0] - 0.1 * s[1][0] ** 3,))

    with jax.enable_x64(dt == "f64"):
        want = getattr(jint, method)(f_jax, (jnp.asarray(x, jd), (jnp.asarray(v, jd),)), 0.05, jnp.asarray(k, jd))
    got = getattr(tint, method)(f_torch, (torch.tensor(x.astype(nd)), (torch.tensor(v.astype(nd)),)), 0.05,
                                torch.tensor(k.astype(nd)))
    assert isinstance(got, tuple) and isinstance(got[1], tuple)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL[dt], atol=TOL[dt])
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(want[1][0]), rtol=TOL[dt], atol=TOL[dt])

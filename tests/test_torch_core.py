"""Port parity for `cmw_tpu_torch.core` (centroidal dynamics, contact plans)
vs `cmw_tpu.core`, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.core import centroidal as jcen
from cmw_tpu.core import contacts as jcon
from cmw_tpu_torch import convert
from cmw_tpu_torch.core import centroidal as tcen
from cmw_tpu_torch.core import contacts as tcon

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-6  # the same f32 arithmetic, sums in another order


def _rot(rng, shape):
    q, _ = np.linalg.qr(rng.standard_normal(shape + (3, 3)))
    return q.astype(np.float32)


def test_centroidal_dynamics_and_corners_match_jax():
    rng = np.random.default_rng(0)
    B, nc, ncor = 3, 2, 4
    x = rng.standard_normal((B, 9)).astype(np.float32)
    forces = rng.standard_normal((B, nc, ncor, 3)).astype(np.float32)
    pos = rng.standard_normal((B, nc, 3)).astype(np.float32)
    rot = _rot(rng, (B, nc))
    corners = rng.standard_normal((nc, ncor, 3)).astype(np.float32)
    active = np.array([[1, 0], [1, 1], [0, 0]], np.float32)
    ef, et = (rng.standard_normal((B, 3)).astype(np.float32) for _ in range(2))

    cj = np.asarray(jcen.corner_world_positions(jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(corners)))
    ct = tcen.corner_world_positions(torch.tensor(pos), torch.tensor(rot), torch.tensor(corners)).numpy()
    np.testing.assert_allclose(ct, cj, rtol=RTOL, atol=ATOL)
    want = np.asarray(jcen.centroidal_dynamics(*map(jnp.asarray, (x, forces, cj, active, ef, et))))
    got = tcen.centroidal_dynamics(*map(torch.tensor, (x, forces, cj, active, ef, et))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    parts = tcen.unpack_state(torch.tensor(x))
    np.testing.assert_array_equal(tcen.pack_state(*parts).numpy(), x)
    assert tcen.GRAVITY == jcen.GRAVITY


@pytest.mark.parametrize("kw", [dict(), dict(n_steps=3, first_swing=1, step_length=0.2, nc_phases=4)])
def test_gait_and_snap_match_jax(kw):
    jplan = jcon.snap_to_grid(jcon.make_alternating_gait(**kw), 0.06)
    tplan = tcon.snap_to_grid(tcon.make_alternating_gait(device="cpu", **kw), 0.06)
    for field in jplan._fields:
        np.testing.assert_array_equal(getattr(tplan, field).numpy(), np.asarray(getattr(jplan, field)), field)
    f64 = tcon.make_alternating_gait(device="cpu", dtype=torch.float64, **kw)
    assert f64.act.dtype == torch.float64


def test_empty_plan_and_converter_match_jax():
    jplan = jcon.empty_plan(nc=2, P=8)
    tplan = tcon.empty_plan(nc=2, P=8, device="cpu")
    back = convert.plan_from_numpy({k: np.asarray(v) for k, v in jplan._asdict().items()}, device="cpu")
    for field in jplan._fields:
        np.testing.assert_array_equal(getattr(tplan, field).numpy(), np.asarray(getattr(jplan, field)), field)
        np.testing.assert_array_equal(getattr(back, field).numpy(), np.asarray(getattr(jplan, field)), field)
    assert tcon.BIG_TIME == jcon.BIG_TIME

"""Port parity for the kernel modules `cmw_tpu_torch.ops` and `cmpc.qp`.

On the CPU each wrapper runs its plain PyTorch twin, which is held here
against the JAX Pallas kernel in interpret mode (as tests/test_ops.py runs
it) on the same numpy inputs. The kernels themselves run only on a CUDA
card: the tests marked `cuda` compare them with their twins there and skip
elsewhere.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.cmpc import ergocub_mpc_config
from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.cmpc import qp as jqp
from cmw_tpu.core import contacts as jcontacts
from cmw_tpu.core.centroidal import pack_state
from cmw_tpu.ops.spd_inverse import spd_inverse_pallas
from cmw_tpu.ops.symv import pack_symmetric as jpack_symmetric
from cmw_tpu.ops.symv import symv_packed as jsymv_packed
from cmw_tpu_torch import convert
from cmw_tpu_torch.cmpc import formulation as TF
from cmw_tpu_torch.cmpc import qp as tqp
from cmw_tpu_torch.ops import spd_inverse as K3
from cmw_tpu_torch.ops import symv as K4

torch.set_num_threads(2)

RESID_TOL = 1e-4  # ||I - M X||_inf, the inverse's done-check (tests/test_ops.py:24)
# The Pallas kernel runs all but its last 3 Newton-Schulz iterations in bf16;
# the f32 tail converges it, but to the f32 round-off of its own block LDL^T
# path, not to the Cholesky's. On this matrix (entries of M^-1 up to ~1) the
# two inverses agree to ~1e-6 relative; 1e-4 leaves room for the bf16 start.
INV_RTOL = 1e-4
SYMV_RTOL, SYMV_ATOL = 2e-5, 1e-4  # f32 sums in another order (tests/test_ops.py:138)
# ADMM: 8 iterations through a KKT inverse whose rows span rho 10..1e4 amplify
# f32 round-off of the two inverses (tests/test_ops.py:101-103 uses 2e-4, 2e-3).
ADMM_RTOL, ADMM_ATOL, ADMM_ATOL_Y = 2e-4, 2e-4, 2e-3


def scaled_spd(B, n, seed=0):
    """The badly scaled SPD matrix of tests/test_ops.py:9-24, for any n."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n)).astype(np.float32) * 0.02
    H = np.einsum("bij,bkj->bik", A, A) + np.eye(n, dtype=np.float32)
    k = min(n, 50)
    H[:, :k, :k] += 1e4 * np.eye(k, dtype=np.float32)  # rho_eq-like rows
    return H


def resid(H, X):
    return np.abs(np.einsum("bij,bjk->bik", H.astype(np.float64), X.astype(np.float64)) - np.eye(H.shape[-1])).max()


def test_spd_inverse_twin_matches_pallas():
    ns = ergocub_mpc_config().ns_iters
    H = scaled_spd(2, 504)
    X_pallas = np.asarray(spd_inverse_pallas(jnp.asarray(H), ns_iters=ns, interpret=True))
    X_twin = K3.spd_inverse_ref(torch.tensor(H)).numpy()
    assert resid(H, X_pallas) < RESID_TOL
    assert resid(H, X_twin) < RESID_TOL
    np.testing.assert_allclose(X_twin, X_pallas, rtol=0, atol=INV_RTOL * np.abs(X_pallas).max())


def test_spd_inverse_plain_routes_agree():
    """The wrapper on a CPU tensor, its twin and the solver's plain Cholesky
    route (`qp.spd_inverse`, the "xla" choice) all invert to the done-check."""
    H = scaled_spd(3, 256, seed=1)
    M = torch.tensor(H)
    for X in (K3.spd_inverse(M), K3.spd_inverse_ref(M), tqp.spd_inverse(M)):
        assert resid(H, X.numpy()) < RESID_TOL
    Xj = np.asarray(jqp.spd_inverse(jnp.asarray(H)))
    np.testing.assert_allclose(tqp.spd_inverse(M).numpy(), Xj, rtol=0, atol=INV_RTOL * np.abs(Xj).max())


def test_symv_twin_matches_pallas():
    rng = np.random.default_rng(7)
    B, n = 2, 256
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    M = A @ np.swapaxes(A, 1, 2) / n
    v = rng.normal(size=(B, n)).astype(np.float32)
    want = np.asarray(jsymv_packed(jpack_symmetric(jnp.asarray(M)), jnp.asarray(v), interpret=True))
    packed = K4.pack_symmetric(torch.tensor(M))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpack_symmetric(jnp.asarray(M))))
    np.testing.assert_array_equal(K4.unpack_symmetric(packed).numpy(), M)
    got = K4.symv_packed(packed, torch.tensor(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=SYMV_RTOL, atol=SYMV_ATOL)
    np.testing.assert_allclose(K4.symv_packed_ref(packed, torch.tensor(v)).numpy(), want,
                               rtol=SYMV_RTOL, atol=SYMV_ATOL)


def test_cpu_wrappers_never_count_launches():
    before = (K3.launches, K4.launches)
    M = torch.tensor(scaled_spd(1, 128))
    K3.spd_inverse(M)
    K4.symv_packed(K4.pack_symmetric(M), torch.ones(1, 128))
    assert (K3.launches, K4.launches) == before


def _walking_problem(cfg):
    plan = jcontacts.snap_to_grid(jcontacts.make_alternating_gait(n_steps=8), cfg.dt)
    stage = jcontacts.mpc_stage_params(plan, 1.02, cfg.T, cfg.dt, cfg.n_slots)
    return JF.MPCParams(
        x0=pack_state(jnp.asarray([0.0, 0.0, 0.7]), jnp.zeros(3), jnp.zeros(3)),
        com_ref=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 0.7]), (cfg.N, 3)),
        ang_mom_ref=jnp.zeros((cfg.N, 3)),
        stage=stage,
        ext_force=jnp.zeros(3),
        ext_torque=jnp.zeros(3),
    )


@pytest.mark.parametrize("xupdate", ["dense", "packed"])
def test_admm_solve_matches_jax(xupdate):
    """`admm_solve` with the dense and the packed-symv x-update vs JAX's
    dense `admm_solve` (test_ops.py:73-103 setup, horizon 0.6)."""
    cfg = ergocub_mpc_config(horizon=0.6)
    jp = _walking_problem(cfg)
    n = cfg.n_vars
    rng = np.random.default_rng(3)
    l, u, rho = JF.constraint_bounds(cfg, jp.stage)
    ata = np.asarray(JF.ata_blockdiag(cfg, jp.stage, rho))
    G = rng.normal(size=(n, n)).astype(np.float32) * 0.05
    M = (G @ G.T + np.eye(n, dtype=np.float32)) + 1e-6 * np.eye(n, dtype=np.float32) + ata
    minv = np.asarray(jqp.spd_inverse(jnp.asarray(M)))
    q = rng.normal(size=(n,)).astype(np.float32)
    x0 = np.zeros(n, np.float32)
    zc0 = np.asarray(jnp.clip(JF.constraint_matvec(cfg, jp.stage, jnp.asarray(x0)), l, u))
    y0 = np.zeros_like(zc0)
    ref, ref_prim = jqp.admm_solve(
        jnp.asarray(minv), jnp.asarray(q), lambda v: JF.constraint_matvec(cfg, jp.stage, v),
        lambda v: JF.constraint_rmatvec(cfg, jp.stage, v), l, u, rho,
        jqp.ADMMState(jnp.asarray(x0), jnp.asarray(zc0), jnp.asarray(y0)), iters=8,
    )

    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    stage = convert.stage_from_numpy({k: np.asarray(v)[None] for k, v in jp.stage._asdict().items()}, device="cpu")
    op = TF.constraint_op(tcfg, stage)
    tl, tu, trho = (torch.tensor(np.asarray(a))[None] for a in (l, u, rho))
    tminv = torch.tensor(minv)[None]
    packed = K4.pack_symmetric(torch.nn.functional.pad(tminv, (0, 512 - n, 0, 512 - n)))
    state, prim = tqp.admm_solve(
        tminv if xupdate == "dense" else None, torch.tensor(q)[None],
        lambda v: TF.op_matvec(tcfg, op, v), lambda v: TF.op_rmatvec(tcfg, op, v), tl, tu, trho,
        tqp.ADMMState(*(torch.tensor(a)[None] for a in (x0, zc0, y0))), iters=8,
        minv_packed=packed if xupdate == "packed" else None,
    )
    np.testing.assert_allclose(state.x[0].numpy(), np.asarray(ref.x), rtol=ADMM_RTOL, atol=ADMM_ATOL)
    np.testing.assert_allclose(state.zc[0].numpy(), np.asarray(ref.zc), rtol=ADMM_RTOL, atol=ADMM_ATOL)
    np.testing.assert_allclose(state.y[0].numpy(), np.asarray(ref.y), rtol=ADMM_RTOL, atol=ADMM_ATOL_Y)
    np.testing.assert_allclose(float(prim[0]), float(ref_prim), rtol=ADMM_RTOL, atol=ADMM_ATOL)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spd_inverse_kernel_matches_twin():
    dev = _cuda()
    H = scaled_spd(4, 504)
    M = torch.tensor(H, device=dev)
    before = K3.launches
    X = K3.spd_inverse(M)
    torch.cuda.synchronize()
    assert K3.launches == before + 1
    assert resid(H, X.cpu().numpy()) < RESID_TOL
    Xr = K3.spd_inverse_ref(M)
    torch.testing.assert_close(X, Xr, rtol=0, atol=INV_RTOL * float(Xr.abs().max()))
    with pytest.raises(TypeError):
        K3.spd_inverse(M.double())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("n", [1, 24, 33, 100])
def test_spd_inverse_kernel_ragged_sizes(n, B):
    """The tiled kernel's masked edge: one tile (1, 24), a full tile and a 1-wide
    one (33), a 4-wide last tile (100)."""
    dev = _cuda()
    H = scaled_spd(B, n, seed=n)
    M = torch.tensor(H, device=dev)
    X = K3.spd_inverse(M)
    torch.cuda.synchronize()
    assert resid(H, X.cpu().numpy()) < RESID_TOL
    Xr = K3.spd_inverse_ref(M)
    torch.testing.assert_close(X, Xr, rtol=0, atol=INV_RTOL * float(Xr.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("B, nb", [(B, nb) for B in (1, 512) for nb in (1, 2, 4)] + [(3, 9)])
def test_symv_kernel_matches_twin(B, nb):
    """One item and the bench batch, up to nb = 9 (n = 1152); two launches on
    the same inputs are bitwise equal."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(7)
    n = nb * K4.BLK
    P = torch.randn(B, n, n, device=dev, generator=gen)
    packed = K4.pack_symmetric(P @ P.transpose(1, 2) / n)
    v = torch.randn(B, n, device=dev, generator=gen)
    before = K4.launches
    out = K4.symv_packed(packed, v)
    again = K4.symv_packed(packed, v)
    torch.cuda.synchronize()
    assert K4.launches == before + 2
    torch.testing.assert_close(out, K4.symv_packed_ref(packed, v), rtol=SYMV_RTOL, atol=SYMV_ATOL)
    assert torch.equal(out, again)
    with pytest.raises(ValueError):
        K4.symv_packed(packed, v[:, 1:].contiguous())

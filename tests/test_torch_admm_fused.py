"""Port parity for the fused ADMM slice: `formulation.constraint_dense` and the
kernel module `ops/admm_fused.py` vs `cmw_tpu`, on the same numpy inputs.

On the CPU the wrapper runs its plain twin, held here against the JAX Pallas
kernel in interpret mode (as tests/test_ops.py:73-103 runs it) for each
operand precision, and against the port's own batched ADMM loop
(`cmpc/qp.admm_solve`). The whole fused solve is a case of
tests/test_torch_solver.py. The kernel itself runs only on a CUDA card: the
test marked `cuda` compares it with its twin there and skips elsewhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.cmpc import ergocub_mpc_config
from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.cmpc import qp as jqp
from cmw_tpu.core import contacts as jcontacts
from cmw_tpu.ops.admm_fused import admm_fused_pallas
from cmw_tpu_torch import convert
from cmw_tpu_torch.cmpc import formulation as TF
from cmw_tpu_torch.cmpc import qp as tqp
from cmw_tpu_torch.ops import admm_fused as K5
from test_torch_admm_fused_schedule import _dense  # a QP on a dense random A: the kernel's dense branch

torch.set_num_threads(2)

T0S = (1.02, 0.9)  # two gait phases: the items' A, l, u and rho differ
ITERS = 8
# f32: 8 iterations through a KKT inverse whose rows span rho 10..1e4 amplify
# the f32 round-off of sums taken in another order (tests/test_ops.py:101-103).
TOL = {"f32": (2e-4, 2e-4, 2e-3)}  # rtol, atol, atol of y
# bf16 modes: both sides round the same matrices to bf16, but each rounds its
# own vector operand, whose entries reach ~1e4 on the rho_eq rows (a bf16 step
# of 64 there). An f32 difference of one ulp in a sum flips such a rounding and
# the iteration carries it on. Measured on these inputs (twin vs the Pallas
# kernel): at most 1.4e-2 (x, zc) and 2.6e-2 (y) for bf16, 1.2e-3 and 3.9e-3
# for bf16x2. Switching between the modes moves y by 1.9, far outside this.
TOL["bf16"] = TOL["bf16x2"] = (2e-3, 3e-2, 6e-2)


def _stage(cfg, t0):
    plan = jcontacts.snap_to_grid(jcontacts.make_alternating_gait(n_steps=8), cfg.dt)
    return jcontacts.mpc_stage_params(plan, t0, cfg.T, cfg.dt, cfg.n_slots)


@pytest.fixture(scope="module")
def problem():
    """tests/test_ops.py:73-103, one item per gait phase in T0S: minv of
    G G^T + I + sigma I + A^T rho A, q random, x0 = 0, zc0 = clip(A x0), y0 = 0."""
    cfg = ergocub_mpc_config()
    n = cfg.n_vars
    rng = np.random.default_rng(3)
    items = []
    for t0 in T0S:
        stage = _stage(cfg, t0)
        l, u, rho = JF.constraint_bounds(cfg, stage)
        A = JF.constraint_dense(cfg, stage)
        G = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32) * 0.05)
        minv = jqp.spd_inverse(G @ G.T + jnp.eye(n) + 1e-6 * jnp.eye(n) + JF.ata_blockdiag(cfg, stage, rho))
        q = jnp.asarray(rng.normal(size=(n,)).astype(np.float32))
        x0 = jnp.zeros(n)
        zc0 = jnp.clip(A @ x0, l, u)
        items.append((minv, A, q, l, u, rho, x0, zc0, jnp.zeros_like(zc0)))
    args = [np.stack([np.asarray(it[k], np.float32) for it in items]) for k in range(9)]
    stages = jax.tree_util.tree_map(lambda *a: np.stack(a), *[_stage(cfg, t0) for t0 in T0S])
    return cfg, stages, args


def _assert_state(got, want, mxu_dtype):
    rtol, atol, atol_y = TOL[mxu_dtype]
    for g, w, a in zip(got, want, (atol, atol, atol_y)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=a)


def test_constraint_dense_matches_jax(problem):
    cfg, stages, args = problem
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tstage = convert.stage_from_numpy(stages, device="cpu")
    got = TF.constraint_dense(tcfg, tstage)
    assert got.shape == (len(T0S), cfg.n_con, cfg.n_vars) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), args[1], rtol=0, atol=1e-6)
    # and it is the matrix of the port's structured operator
    v = torch.tensor(np.random.default_rng(5).normal(size=(len(T0S), cfg.n_vars)).astype(np.float32))
    op = TF.constraint_op(tcfg, tstage)
    np.testing.assert_allclose(torch.matmul(got, v[..., None])[..., 0].numpy(), TF.op_matvec(tcfg, op, v).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mxu_dtype", K5.MXU_DTYPES)
def test_twin_and_cpu_wrapper_match_pallas(problem, mxu_dtype):
    _, _, args = problem
    want = admm_fused_pallas(*map(jnp.asarray, args), iters=ITERS, interpret=True, mxu_dtype=mxu_dtype)
    targs = [torch.tensor(a) for a in args]
    before = K5.launches
    for fn in (K5.admm_fused_ref, K5.admm_fused):
        got = fn(*targs, iters=ITERS, mxu_dtype=mxu_dtype)
        assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
        _assert_state([g.numpy() for g in got], want, mxu_dtype)
    assert K5.launches == before  # CPU tensors never reach the kernel


def test_twin_matches_admm_solve(problem):
    """The twin (y * rinv) and the port's batched ADMM loop (y / rho) on the
    dense minv and the structured operator agree to the f32 tolerance."""
    cfg, stages, args = problem
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    op = TF.constraint_op(tcfg, convert.stage_from_numpy(stages, device="cpu"))
    minv, _, q, l, u, rho, x0, zc0, y0 = (torch.tensor(a) for a in args)
    state, prim = tqp.admm_solve(minv, q, lambda v: TF.op_matvec(tcfg, op, v), lambda v: TF.op_rmatvec(tcfg, op, v),
                                 l, u, rho, tqp.ADMMState(x0, zc0, y0), iters=ITERS)
    got = K5.admm_fused_ref(*(torch.tensor(a) for a in args), iters=ITERS)
    _assert_state([g.numpy() for g in got], [s.numpy() for s in state], "f32")
    assert float(prim.max()) < 1.0  # finite and on its way down after 8 iterations


def test_unknown_mxu_dtype_raises(problem):
    _, _, args = problem
    with pytest.raises(ValueError, match="mxu_dtype"):
        K5.admm_fused(*(torch.tensor(a) for a in args), iters=1, mxu_dtype="fp8")


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_dtype", K5.MXU_DTYPES)
def test_kernel_matches_twin(problem, mxu_dtype):
    """The walking QPs (row lists) and a dense random A (the dense branch):
    one launch each, within the tolerance of the twin, and two launches on the
    same inputs bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for args in (problem[2], _dense()):
        targs = [torch.tensor(a, device="cuda") for a in args]
        before = K5.launches
        got = K5.admm_fused(*targs, iters=ITERS, mxu_dtype=mxu_dtype)
        again = K5.admm_fused(*targs, iters=ITERS, mxu_dtype=mxu_dtype)
        torch.cuda.synchronize()
        assert K5.launches == before + 2
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        want = K5.admm_fused_ref(*targs, iters=ITERS, mxu_dtype=mxu_dtype)
        _assert_state([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want], mxu_dtype)
    with pytest.raises(TypeError):
        K5.admm_fused(*(t.double() for t in targs), iters=ITERS)

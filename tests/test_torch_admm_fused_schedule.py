"""The schedule of the fused ADMM kernel (`cmw_tpu_torch/csrc/admm_fused.cu`).

The kernel runs only on a CUDA card. This file holds a plain PyTorch model of
its order of work:
  0. the launch, chosen from n and m alone (`plan_model`): a cluster of 8,
     else 16 blocks whose shares of minv fit beside the lists and vectors,
     else one block per scenario streaming minv, with the lists if they fit
     and else without them (every scenario then takes the dense branch);
  1. the compaction: each row of A to a list of at most ROW_CAP non-zeros in
     ascending column order, the count per column, and a scenario's dense flag
     when a row passes ROW_CAP or a column COL_CAP;
  2. the loop, per scenario: column lists built from the row lists in row
     order; per iteration rhs = sigma x - q + A^T w from the column lists, x =
     minv rhs by one row slice of S = ceil(n / cluster) rows a block (the last
     ragged), each slice written into every block's copy of x (double-buffered
     by parity in a cluster), then A x from the row lists with the clip and
     dual updates. A flagged scenario takes the dense A for both products.
The model is held against the port's plain twin and against the Pallas kernel
in interpret mode in each operand precision, on the walking QPs of
tests/test_torch_admm_fused.py, on a dense random A (every row overflows: the
dense branch) and at ragged sizes with one row over ROW_CAP, and in f32 on the
walking QPs of the longer horizons that take each of the other launches, so an
index slip in the schedule shows up here on the CPU. The `cuda` tests hold the
kernel's own `plan` to `plan_model`.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.cmpc import ergocub_mpc_config
from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.cmpc import qp as jqp
from cmw_tpu.core import contacts as jcontacts
from cmw_tpu.ops.admm_fused import admm_fused_pallas
from cmw_tpu_torch.ops import admm_fused as K5

torch.set_num_threads(2)

ROW_CAP, COL_CAP = 3, 6  # kRowCap, kColCap
SMEM_BYTES = 232_448  # kMaxSmem: shared memory one H100 block may use
ITERS = 8
# tests/test_torch_admm_fused.py:36-43: (rtol, atol, atol of y); the bf16 modes
# round each side's own vector operand (entries up to ~1e4) to bf16
TOL = {"f32": (2e-4, 2e-4, 2e-3), "bf16": (2e-3, 3e-2, 6e-2), "bf16x2": (2e-3, 3e-2, 6e-2)}
T0S = (1.02, 0.9)  # the walking QPs' gait phases (tests/test_torch_admm_fused.py)
# horizons (T at dt = 0.06) whose sizes take each launch past the production
# one: 8 blocks a cluster up to T = 21, 16 to T = 27, one block per scenario
# with the lists to T = 54, without them to T = 111
DT = 0.06  # ergocub_mpc_config().dt
LAUNCH_T = {"cluster 16": 22, "one block": 33, "one block, no lists": 60}


def plan_model(n, m):
    """The kernel's `plan`: (blocks a cluster, lists held) of the first launch
    whose block fits SMEM_BYTES, or None. A cluster's blocks hold a 16-byte
    mbarrier, a 16-byte-rounded slice of minv and x twice; one block per
    scenario streams minv and holds x once."""
    def smem(cluster, lists):
        minv = (-(-n // cluster) * n * 4 + 15) // 16 * 16 + 16 if cluster > 1 else 0
        vectors = 4 * ((2 + (2 if cluster > 1 else 1)) * n + 7 * m)
        return minv + vectors + (4 * (m * ROW_CAP + n * COL_CAP + n) + 2 * (m * ROW_CAP + n * COL_CAP) if lists else 0)
    for cluster, lists in ((8, True), (16, True), (1, True), (1, False)):
        if n > 0 and m > 0 and smem(cluster, lists) <= SMEM_BYTES:
            return cluster, lists
    return None


def _walking(T=20):
    """tests/test_torch_admm_fused.py `problem` at horizon T: minv of G G^T +
    I + sigma I + A^T rho A, q random, x0 = 0, zc0 = clip(A x0), y0 = 0, one
    item per phase."""
    cfg = ergocub_mpc_config(horizon=round(T * DT, 6))
    n = cfg.n_vars
    rng = np.random.default_rng(3)
    items = []
    for t0 in T0S:
        plan = jcontacts.snap_to_grid(jcontacts.make_alternating_gait(n_steps=8), cfg.dt)
        stage = jcontacts.mpc_stage_params(plan, t0, cfg.T, cfg.dt, cfg.n_slots)
        l, u, rho = JF.constraint_bounds(cfg, stage)
        A = JF.constraint_dense(cfg, stage)
        G = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32) * 0.05)
        minv = jqp.spd_inverse(G @ G.T + jnp.eye(n) + 1e-6 * jnp.eye(n) + JF.ata_blockdiag(cfg, stage, rho))
        q = jnp.asarray(rng.normal(size=(n,)).astype(np.float32))
        x0 = jnp.zeros(n)
        zc0 = jnp.clip(A @ x0, l, u)
        items.append((minv, A, q, l, u, rho, x0, zc0, jnp.zeros_like(zc0)))
    return [np.stack([np.asarray(it[k], np.float32) for it in items]) for k in range(9)]


def _qp(A, seed):
    """A QP around the constraint matrices A [B, m, n]: minv of G G^T + I +
    A^T rho A, rho in [0.1, 10], bounds around 0, q random, cold start."""
    rng = np.random.default_rng(seed)
    B, m, n = A.shape
    rho = rng.uniform(0.1, 10.0, size=(B, m))
    G = rng.normal(size=(B, n, n)) * 0.05
    M = G @ G.transpose(0, 2, 1) + np.eye(n) + np.einsum("bri,br,brj->bij", A, rho, A)
    l, u = -np.abs(rng.normal(size=(B, m))), np.abs(rng.normal(size=(B, m)))
    q = rng.normal(size=(B, n))
    x0, zc0, y0 = np.zeros((B, n)), np.zeros((B, m)), np.zeros((B, m))
    return [np.asarray(a, np.float32) for a in (np.linalg.inv(M), A, q, l, u, rho, x0, zc0, y0)]


def _dense(B=2, n=40, m=56, seed=11):
    """A dense random A: every row passes ROW_CAP, so both items take the dense branch."""
    return _qp(np.random.default_rng(seed).normal(size=(B, m, n)) / np.sqrt(n), seed)


def _ragged(n=37, m=50, seed=13):
    """n = 37 (slices of 5 rows, the last 2), m = 50: identity rows, then rows
    of 2-3 entries with every column at most COL_CAP; item 1 also has one row
    of ROW_CAP + 1 entries, so only item 1 is flagged dense."""
    rng = np.random.default_rng(seed)
    A = np.zeros((2, m, n))
    A[:, np.arange(n), np.arange(n)] = 1.0
    for b in range(2):
        for r in range(n, m):
            cols = rng.choice(n, size=rng.integers(2, ROW_CAP + 1), replace=False)
            A[b, r, cols] = rng.normal(size=len(cols))
    A[1, m - 1, :ROW_CAP + 1] = rng.normal(size=ROW_CAP + 1)
    assert ((A != 0).sum(1) <= COL_CAP).all()
    return _qp(A, seed)


CASES = {"walking": _walking, "dense": _dense, "ragged": _ragged,
         **{f"walking T={T}": functools.partial(_walking, T) for T in LAUNCH_T.values()}}
DENSE_FLAGS = {"walking": [False, False], "dense": [True, True], "ragged": [False, True],
               "walking T=22": [False, False], "walking T=33": [False, False], "walking T=60": [True, True]}


@functools.lru_cache(maxsize=None)
def problem(case):
    return CASES[case]()


@functools.lru_cache(maxsize=None)
def pallas(case, mxu_dtype):
    out = admm_fused_pallas(*map(jnp.asarray, problem(case)), iters=ITERS, interpret=True, mxu_dtype=mxu_dtype)
    return [np.asarray(o) for o in out]


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def compact(A):
    """Launch 1 on [B, m, n]: row values and columns [B, m, ROW_CAP] in
    ascending column order (value 0 and column -1 in an unused slot), column
    counts [B, n] and dense flags [B]."""
    B, m, n = A.shape
    nz = A != 0  # NaN counts as a non-zero
    slot = nz.cumsum(-1) - 1
    vals = torch.zeros(B, m, ROW_CAP)
    cols = torch.full((B, m, ROW_CAP), -1, dtype=torch.long)
    b, r, c = (nz & (slot < ROW_CAP)).nonzero(as_tuple=True)
    vals[b, r, slot[b, r, c]] = A[b, r, c]
    cols[b, r, slot[b, r, c]] = c
    counts = nz.sum(1)
    dense = (nz.sum(-1) > ROW_CAP).any(-1) | (counts > COL_CAP).any(-1)
    return vals, cols, counts, dense


def column_lists(vals, cols, n):
    """One scenario's column lists [n, COL_CAP] (values, rows) from its row
    lists, filled in row order, and the count of each."""
    cval = torch.zeros(n, COL_CAP)
    crow = torch.zeros(n, COL_CAP, dtype=torch.long)
    cnt = torch.zeros(n, dtype=torch.long)
    for r in range(vals.shape[0]):
        for k in range(ROW_CAP):
            c = int(cols[r, k])
            if c < 0:
                break
            assert cnt[c] < COL_CAP, "a column list overflows in a scenario whose flag is clear"
            cval[c, cnt[c]], crow[c, cnt[c]] = vals[r, k], r
            cnt[c] += 1
    return cval, crow, cnt


def list_dot(a, v, mxu_dtype):
    """sum_k a[..., k] v[..., k] in the order k = 0, 1, ... (Dot<kMode>): a
    rounded as the mode says, v already the operand."""
    hi, lo = torch.zeros(a.shape[:-1]), torch.zeros(a.shape[:-1])
    for k in range(a.shape[-1]):
        ak = a[..., k] if mxu_dtype == "f32" else _bf16(a[..., k])
        hi = hi + ak * v[..., k]
        if mxu_dtype == "bf16x2":
            lo = lo + _bf16(a[..., k] - ak) * v[..., k]
    return hi + lo


def matvec(M, v, mxu_dtype):
    """M v with M rounded as the mode says, v already the operand."""
    if mxu_dtype == "f32":
        return M @ v
    hi = _bf16(M)
    return hi @ v + (_bf16(M - hi) @ v if mxu_dtype == "bf16x2" else 0.0)


def schedule_model(minv, A, q, l, u, rho, x0, zc0, y0, *, iters, mxu_dtype, sigma=1e-6, alpha=1.6):
    """The kernel's two launches; returns ((x, zc, y), dense flags)."""
    B, n, _ = minv.shape
    cluster, lists = plan_model(n, A.shape[1])
    op = _bf16 if mxu_dtype != "f32" else (lambda t: t)
    if lists:
        vals, cols, _, dense = compact(A)
    else:  # no compaction: every scenario takes the dense branch
        dense = torch.ones(B, dtype=torch.bool)
    S = -(-n // cluster)
    slices = [slice(min(r * S, n), min(r * S + S, n)) for r in range(cluster)]  # the last ragged or empty
    nbuf = 2 if cluster > 1 else 1  # x by parity in a cluster, once in one block
    outs = []
    for b in range(B):  # one cluster (or block) per scenario
        if not dense[b]:
            cval, crow, cnt = column_lists(vals[b], cols[b], n)
            assert (cval[torch.arange(COL_CAP) >= cnt[:, None]] == 0).all()
            rcol = cols[b].clamp(min=0)  # an unused slot holds value 0
        xb = torch.full((cluster, nbuf, n), float("nan"))  # every block's x
        xb[:, 0] = x0[b]
        zc, y, rinv = zc0[b], y0[b], 1.0 / rho[b]
        w = op(rho[b] * zc - y)
        for it in range(iters):
            cur, nxt = it % nbuf, (it + 1) % nbuf
            x = xb[0, cur]
            atw = matvec(A[b].T, w, mxu_dtype) if dense[b] else list_dot(cval, w[crow], mxu_dtype)
            rhs = op(sigma * x - q[b] + atw)
            xb[:, nxt] = float("nan")
            for sl in slices:  # block r's rows of minv rhs, written into every block
                xb[:, nxt, sl] = matvec(minv[b, sl], rhs, mxu_dtype)
            assert not xb[:, nxt].isnan().any(), "a row of x was never written"
            xn = op(xb[0, nxt])
            ax = matvec(A[b], xn, mxu_dtype) if dense[b] else list_dot(vals[b], xn[rcol], mxu_dtype)
            zh = alpha * ax + (1.0 - alpha) * zc
            zn = torch.minimum(torch.maximum(zh + y * rinv, l[b]), u[b])
            y = y + rho[b] * (zh - zn)
            zc = zn
            w = op(rho[b] * zc - y)
        outs.append((xb[0, iters % nbuf], zc, y))
    return tuple(torch.stack(o) for o in zip(*outs)), dense


def _assert_state(got, want, mxu_dtype):
    rtol, atol, atol_y = TOL[mxu_dtype]
    for g, w, a in zip(got, want, (atol, atol, atol_y)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=a)


@pytest.mark.parametrize("mxu_dtype", K5.MXU_DTYPES)
@pytest.mark.parametrize("case", ["walking", "dense", "ragged"])
def test_schedule_matches_twin_and_pallas(case, mxu_dtype):
    args = [torch.tensor(a) for a in problem(case)]
    got, dense = schedule_model(*args, iters=ITERS, mxu_dtype=mxu_dtype)
    assert dense.tolist() == DENSE_FLAGS[case]
    twin = K5.admm_fused_ref(*args, iters=ITERS, mxu_dtype=mxu_dtype)
    _assert_state([g.numpy() for g in got], [t.numpy() for t in twin], mxu_dtype)
    _assert_state([g.numpy() for g in got], pallas(case, mxu_dtype), mxu_dtype)


@pytest.mark.parametrize("launch", list(LAUNCH_T))
def test_schedule_of_each_launch_matches_twin_and_pallas(launch):
    """The walking QPs of a horizon that takes each launch past the production
    one, in f32: 16 blocks a cluster at T = 22 (n = 552, m = 1,432), one block
    per scenario with the lists at T = 33 and without them at T = 60."""
    case = f"walking T={LAUNCH_T[launch]}"
    args = [torch.tensor(a) for a in problem(case)]
    assert plan_model(args[0].shape[1], args[1].shape[1]) == {
        "cluster 16": (16, True), "one block": (1, True), "one block, no lists": (1, False)}[launch]
    got, dense = schedule_model(*args, iters=ITERS, mxu_dtype="f32")
    assert dense.tolist() == DENSE_FLAGS[case]
    twin = K5.admm_fused_ref(*args, iters=ITERS)
    _assert_state([g.numpy() for g in got], [t.numpy() for t in twin], "f32")
    _assert_state([g.numpy() for g in got], pallas(case, "f32"), "f32")


def test_plan_holds_every_size_the_vectors_allow():
    """Every horizon whose vectors fit one block (4 (3 n + 7 m) bytes, the
    kernel's first design) has a launch, in the order 8 blocks a cluster, 16,
    one block with the lists, one block without; the production size takes
    8 blocks."""
    cfg = ergocub_mpc_config()
    assert plan_model(cfg.n_vars, cfg.n_con) == (8, True)
    seen = []
    for T in range(1, 130):
        c = ergocub_mpc_config(horizon=round(T * DT, 6))
        n, m = c.n_vars, c.n_con
        got = plan_model(n, m)
        assert (got is not None) == (4 * (3 * n + 7 * m) <= SMEM_BYTES), T
        if got is not None and got not in seen:
            seen.append(got)
    assert seen == [(8, True), (16, True), (1, True), (1, False)]


def test_walking_A_within_the_caps():
    """The walking A: at most ROW_CAP non-zeros a row and COL_CAP a column
    (identity rows 1, cone rows D R_k^T and position rows R^T up to 3; a force
    column 1 identity + 5 cone entries), at the production horizon and at the
    longer ones that hold the lists."""
    for case in ("walking", "walking T=22", "walking T=33"):
        A = torch.tensor(problem(case)[1])
        nz = A != 0
        assert int(nz.sum(-1).max()) <= ROW_CAP and int(nz.sum(1).max()) <= COL_CAP
        _, _, counts, dense = compact(A)
        assert not dense.any() and (counts == nz.sum(1)).all()


@pytest.mark.cuda
def test_plan_matches_the_model():
    """The kernel's `plan` (its shared-memory layout) against `plan_model`,
    over the horizons and at small and ragged sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cfgs = [ergocub_mpc_config(horizon=round(T * DT, 6)) for T in range(1, 130)]
    sizes = [(c.n_vars, c.n_con) for c in cfgs] + [(37, 50), (40, 56), (1, 1), (0, 5), (5, 0)]
    for n, m in sizes:
        got = K5.plan(n, m)
        assert (None if got is None else (got.cluster, got.lists)) == plan_model(n, m), (n, m)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", *(f"walking T={T}" for T in LAUNCH_T.values())])
def test_kernel_matches_twin_on_the_card(case):
    """The kernel at ragged sizes in each precision and on the launches of
    the longer horizons in f32: within the tolerance of the twin, two
    launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = [torch.tensor(a, device="cuda") for a in problem(case)]
    for mxu_dtype in K5.MXU_DTYPES if case == "ragged" else ("f32",):
        got = K5.admm_fused(*args, iters=ITERS, mxu_dtype=mxu_dtype)
        again = K5.admm_fused(*args, iters=ITERS, mxu_dtype=mxu_dtype)
        torch.cuda.synchronize()
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        want = K5.admm_fused_ref(*args, iters=ITERS, mxu_dtype=mxu_dtype)
        _assert_state([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want], mxu_dtype)

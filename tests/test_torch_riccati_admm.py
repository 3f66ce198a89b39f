"""The Riccati ADMM kernel (K2, `ops/riccati_admm.py`, `csrc/riccati_admm.cu`).

On the CPU:
  - the twin `riccati_admm_ref` is bitwise the solver's loop as it stood
    before the kernel (`qp.admm_solve` with `riccati_apply` and the block-local
    operator) at both presets' shapes, f64 and f32, B 1 and 3;
  - the wrapper on CPU tensors is the twin, and its launch counter stays;
  - a PyTorch model of the kernel's own schedule (its row groups and flat
    indices, the folded rhs and relaxation passes, the two-phase sweeps, the
    products of P taken for all stages at once, the split of K s into its y
    and u parts, D1 read by columns) equals the twin in f64 to round-off:
    change the model with the kernel.
On the card (`-m cuda`) the kernel against the twin on walking QPs recorded
from a cold Riccati solve at the bench's pushes, B 1, 256 and 512, both
shapes (at B = 1 bitwise); 24 launches bitwise equal; a CUDA-graph replay bitwise equal to the
eager launch; a graphed Riccati solve counting sqp_iters launches a replay.

The inputs are the port's own (no JAX), so the card's tests can run here.
"""

import pytest
import torch

import chip_smoke
from cmw_tpu_torch.apps import bench as BENCH
from cmw_tpu_torch.cmpc import CentroidalMPCSolver
from cmw_tpu_torch.cmpc import formulation as F
from cmw_tpu_torch.cmpc import qp
from cmw_tpu_torch.cmpc import riccati as ric
from cmw_tpu_torch.ops import riccati_admm as K2
from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1, ergocub_sn000

torch.set_num_threads(2)

SHAPES = {"gz": ergocub_gazebo_v1().mpc, "sn000": ergocub_sn000().mpc}  # T 20, admm 24; T 13, admm 30
MODEL_RTOL = 1e-12  # f64: the model and the twin sum in other orders


def walking_qps(cfg, B, *, device, dtype=torch.float32):
    """The ADMM inputs of each SQP step of a cold Riccati solve at the bench's
    walking parameters: [(fac, op, (q, l, u, rho, x, zc, y))]."""
    return chip_smoke.riccati_qps(cfg, B, device=device, dtype=dtype)


def kw(cfg):
    return dict(iters=cfg.admm_iters, sigma=cfg.admm_sigma, alpha=cfg.admm_alpha)


def solver_loop(cfg, fac, op, q, l, u, rho, x, zc, y):
    """The solver's Riccati `run_admm` before the kernel, verbatim."""
    return qp.admm_solve(
        None, q, lambda v: F.op_matvec(cfg, op, v), lambda v: F.op_rmatvec(cfg, op, v), l, u, rho,
        qp.ADMMState(x, zc, y), iters=cfg.admm_iters, sigma=cfg.admm_sigma, alpha=cfg.admm_alpha,
        apply_fn=lambda r: ric.riccati_apply(cfg, fac, r),
    )


def flat_state(state, prim):
    return (*state, prim)


@pytest.fixture(scope="module", params=list(SHAPES))
def shape(request):
    return request.param


@pytest.fixture(scope="module")
def cpu_qps(shape):
    """{(dtype, B): the recorded QPs} on the CPU for one preset's shape."""
    cfg = SHAPES[shape]
    return cfg, {(d, B): walking_qps(cfg, B, device="cpu", dtype=d)
                 for d in (torch.float32, torch.float64) for B in (1, 3)}


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_twin_is_the_solver_loop(cpu_qps, dtype, B):
    cfg, qps = cpu_qps
    for fac, op, args in qps[(dtype, B)]:
        want = flat_state(*solver_loop(cfg, fac, op, *args))
        got = flat_state(*K2.riccati_admm_ref(cfg, fac, op, *args, **kw(cfg)))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert want[0].dtype == dtype and want[0].shape == (B, cfg.n_vars)


def test_cpu_wrapper_is_the_twin(cpu_qps):
    cfg, qps = cpu_qps
    before = K2.launches
    for fac, op, args in qps[(torch.float32, 3)]:
        got = flat_state(*K2.riccati_admm(cfg, fac, op, *args, **kw(cfg)))
        want = flat_state(*K2.riccati_admm_ref(cfg, fac, op, *args, **kw(cfg)))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K2.launches == before  # CPU tensors never reach the kernel


# --- a model of the kernel's schedule ------------------------------------------


def kernel_model(cfg, fac, op, q, l, u, rho, x, zc, y, *, iters, sigma, alpha):
    """The kernel's loop written in its own terms (csrc/riccati_admm.cu), over
    the batch at once: gains read from flat per-scenario arrays at the
    kernel's offsets and strides, every output of a phase from the state the
    phase before left."""
    B, T, nu, ns = fac.K.shape
    nc, nslot = op.slot_rot.shape[1:3]
    ncor = nu // (3 * nc)
    np_ = 3 * nc * nslot
    nf, ncg = T * nu, T * nc * ncor
    tcc3, tcc5 = 3 * ncg, 5 * ncg
    gA, gB, gC, gK, gKP, gD1, gSinv = (t.reshape(B, -1) for t in fac)
    ar = torch.arange

    def dot(flat, offsets, stride, v):
        """flat[:, offsets[o] + i stride] . v[:, i] for every o: [B, len(offsets)]."""
        idx = offsets[:, None] + ar(v.shape[1])[None, :] * stride
        return (flat[:, idx] * v[:, None, :]).sum(-1)

    # row groups: corner g owns force rows 3g + c, cone rows tcc3 + 5g + d and
    # variables 3g + c; slot s owns rows tcc3 + tcc5 + 3s + a, variables nf + 3s + b
    g = ar(ncg)
    frows = 3 * g[:, None] + ar(3)
    crows = tcc3 + 5 * g[:, None] + ar(5)
    prows = tcc3 + tcc5 + 3 * ar(nc * nslot)[:, None] + ar(3)
    gt, gi = g // (nc * ncor), (g // ncor) % nc
    coef = op.cone_coeff[:, gt, gi]  # [B, ncg, 5, 3]
    rot = op.slot_rot.reshape(B, nc * nslot, 3, 3)  # [B, slot, b, a]
    xr, zc, y = x.clone(), zc.clone(), y.clone()

    def matvec(xv):
        xf, xp = xv[:, :nf].reshape(B, ncg, 3), xv[:, nf:].reshape(B, -1, 3)
        ax = torch.empty_like(zc)
        ax[:, frows] = xf
        ax[:, crows] = (coef * xf[:, :, None, :]).sum(-1)
        ax[:, prows] = (rot * xp[:, :, :, None]).sum(-2)
        return ax

    for _ in range(iters):
        w = rho * zc - y
        at = torch.empty_like(xr)
        at[:, :nf] = (w[:, frows] + (w[:, crows][..., None] * coef).sum(-2)).reshape(B, -1)
        at[:, nf:] = (rot * w[:, prows][:, :, None, :]).sum(-1).reshape(B, -1)
        rhs = (sigma * xr - q) + at

        gam, pi = rhs.new_zeros(B, ns), rhs.new_zeros(B, np_)
        ff = rhs.new_zeros(B, T, nu)
        for t in reversed(range(T)):
            gam9 = gam[:, :9]
            gv = (dot(gB, t * 9 * nu + ar(nu), nu, gam9) + gam[:, 9:]) - rhs[:, t * nu:(t + 1) * nu]
            ag = dot(gA, t * 81 + ar(9), 9, gam9)
            cg = pi + dot(gC, t * 9 * np_ + ar(np_), np_, gam9)
            gam = torch.cat([ag, rhs.new_zeros(B, nu)], -1) - dot(gK, t * nu * ns + ar(ns), ns, gv)
            ff[:, t] = dot(gD1, t * nu * nu + ar(nu), nu, gv)  # column k of D1
            pi = cg - dot(gKP, t * nu * np_ + ar(np_), np_, gv)
        P = -dot(gSinv, ar(np_) * np_, 1, pi - rhs[:, nf:])
        kpp = dot(gKP, ar(nf) * np_, 1, P).reshape(B, T, nu)  # row (t, k) of KP_t at (t nu + k) np
        cpp = dot(gC, ar(9 * T) * np_, 1, P).reshape(B, T, 9)
        yv, us = rhs.new_zeros(B, 9), []
        for t in range(T):
            ks = dot(gK, t * nu * ns + ar(nu) * ns, 1, yv)
            if t > 0:
                ks = ks + dot(gK, t * nu * ns + ar(nu) * ns + 9, 1, us[-1])
            ut = (-ks - kpp[:, t]) - ff[:, t]
            ay = dot(gA, t * 81 + ar(9) * 9, 1, yv)
            yv = (ay + dot(gB, t * 9 * nu + ar(9) * nu, 1, ut)) + cpp[:, t]
            us.append(ut)
        xr = torch.cat(us + [P], -1)

        ax = matvec(xr)
        zh = alpha * ax + (1.0 - alpha) * zc
        zn = torch.clamp(zh + y / rho, l, u)
        y = y + rho * (zh - zn)
        zc = zn
    return qp.ADMMState(xr, zc, y), (matvec(xr) - zc).abs().amax(-1)


@pytest.mark.parametrize("B", [1, 3])
def test_schedule_model_matches_the_twin(cpu_qps, B):
    cfg, qps = cpu_qps
    for fac, op, args in qps[(torch.float64, B)]:
        want = flat_state(*K2.riccati_admm_ref(cfg, fac, op, *args, **kw(cfg)))
        got = flat_state(*kernel_model(cfg, fac, op, *args, **kw(cfg)))
        for name, gg, ww in zip(("x", "zc", "y", "prim_res"), got, want):
            err = float((gg - ww).abs().max() / ww.abs().max().clamp(min=1.0))
            assert err < MODEL_RTOL, (name, err)


def test_schedule_model_takes_zero_iterations(cpu_qps):
    cfg, qps = cpu_qps
    fac, op, args = qps[(torch.float64, 3)][0]
    zero = dict(kw(cfg), iters=0)
    got = flat_state(*kernel_model(cfg, fac, op, *args, **zero))
    want = flat_state(*K2.riccati_admm_ref(cfg, fac, op, *args, **zero))
    assert all(torch.allclose(g, w, rtol=0, atol=1e-12) for g, w in zip(got, want))


# --- on the card -----------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 256, 512])
def test_kernel_matches_twin_on_walking_qps(card, shape, B):
    """f32 within chip_smoke.K2_GAP times the twin's own f32-vs-f64 gap (at
    B > 1 cuBLAS may sum the twin's products in other orders, through 24-30
    iterations whose rows span rho 10 .. 1e4 and clip at active bounds, so
    neither is the closer one on every input), f64 within 1e-12 of the
    twin's f64, two launches bitwise equal, and at B = 1 bitwise the twin in
    f32 (`chip_smoke.check_riccati_admm` raises otherwise)."""
    cfg = SHAPES[shape]
    chip_smoke.check_riccati_admm(f"{shape} B={B}", cfg, walking_qps(cfg, B, device=card))


@pytest.mark.cuda
def test_launches_bitwise_equal_and_graph_replay(card, shape):
    cfg = SHAPES[shape]
    fac, op, args = walking_qps(cfg, 256, device=card)[0]
    first = flat_state(*K2.riccati_admm(cfg, fac, op, *args, **kw(cfg)))
    for _ in range(23):
        again = flat_state(*K2.riccati_admm(cfg, fac, op, *args, **kw(cfg)))
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        K2.riccati_admm(cfg, fac, op, *args, **kw(cfg))  # warm-up off the capture
        with torch.cuda.graph(graph, stream=stream):
            out = K2.riccati_admm(cfg, fac, op, *args, **kw(cfg))
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(flat_state(*out), first))


@pytest.mark.cuda
def test_graphed_solve_counts_sqp_iters_launches(card, shape):
    cfg = SHAPES[shape]
    solver = CentroidalMPCSolver(cfg)
    params = BENCH.make_params(cfg, BENCH.lateral_pushes(4), device=card)
    warm = solver.cold_start(4, device=card)
    solver.solve(params, warm)  # the capture
    before = K2.launches
    for _ in range(3):
        solver.solve(params, warm)
    torch.cuda.synchronize()
    assert K2.launches - before == 3 * cfg.sqp_iters

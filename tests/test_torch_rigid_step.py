"""The rigid plant's tick kernel (K6, `ops/rigid_step.py`, `csrc/rigid_step.cu`).

On the CPU:
  - a PyTorch model of the kernel's algorithm, reading the model's tables at
    the kernel's offsets (FK by walking each link's path, the mass matrix by
    composite inertias about the base origin, the bias forces by one
    Newton-Euler pass plus the chart's w_base x L term, the corner Jacobians,
    the right-looking Cholesky and the substitutions in the kernel's order,
    the active-set pass that solves again only where a corner dropped, the
    Coulomb cap, the anchors, the servo and the integration) equals the twin
    `rigid_body._dynamics_step` and its autodiff mass matrix and bias forces
    in f64 within MODEL_RTOL, on settled, pushed, airborne and
    one-foot-separating states, B 1 and 3, substeps 1 and 2: change the model
    with the kernel;
  - on a base rotation sheared as f32 ticks leave it, M is still the twin's
    and b parts from the twin's autodiff by a small fraction of the shear;
  - `dynamics_step` on CPU tensors is the twin and moves no launch count;
    the launcher takes no CPU tensor;
  - `plan` has no launch for another tree or past shared memory, and the
    launcher then raises.
On the card (`-m cuda`): the kernel against the twin at B 1 and 256 (f32
within K6_GAP times the twin's own f32-vs-f64 gap, f64 within K6_F64_RTOL), 24
launches bitwise equal, a graph replay bitwise the eager launch, and a graphed
rigid period counting one launch a WBC tick.

The inputs are the port's own (no JAX), so the card's tests can run there.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from cmw_tpu_torch import convert
from cmw_tpu_torch.core import kinematics as TK
from cmw_tpu_torch.core import lie
from cmw_tpu_torch.core.centroidal import GRAVITY
from cmw_tpu_torch.ops import rigid_step as K6
from cmw_tpu_torch.runtime import loop as RL
from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1
from cmw_tpu_torch.sim import rigid_body as RB

torch.set_num_threads(2)

MODEL_RTOL = chip_smoke.K6_F64_RTOL  # f64: closed forms against autodiff, sums in other orders
DT = chip_smoke.K6_DT


def rel_gap(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1.0))


# --- a model of the kernel's algorithm ---------------------------------------------


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def unpack(model, sole_frames=RB.SOLES, corners_local=None) -> dict:
    """The model's float and int tables (`K6._tables`) cut at the kernel's
    offsets."""
    cl = RB.default_corners(len(sole_frames)) if corners_local is None else np.asarray(corners_local)
    nfeet, ncor = cl.shape[:2]
    floats, ints = K6._tables(model, tuple(sole_frames), tuple(map(tuple, cl.reshape(-1, 3).tolist())))
    nj, nl = model.nj, model.nj + 1
    assert len(floats) == K6.float_table_len(nj, nfeet, ncor) and len(ints) == nj + 2 * nl + nfeet
    f, out, at = torch.tensor(floats, dtype=torch.float64), {}, 0
    for name, shape in (("axis", (nj, 3)), ("opos", (nj, 3)), ("orot", (nj, 3, 3)), ("mass", (nl,)),
                        ("com", (nl, 3)), ("inertia", (nl, 3, 3)), ("frot", (nfeet, 3, 3)), ("fpos", (nfeet, 3)),
                        ("corners", (nfeet, ncor, 3))):
        size = int(np.prod(shape))
        out[name], at = f[at:at + size].reshape(shape), at + size
    out["parent"] = list(ints[:nj])
    out["anc"], out["sub"] = list(ints[nj:nj + nl]), list(ints[nj + nl:nj + 2 * nl])
    out["flink"] = list(ints[nj + 2 * nl:])
    out.update(nj=nj, nl=nl, nfeet=nfeet, ncor=ncor)
    return out


def bits(mask: int, n: int) -> list:
    return [i for i in range(n) if mask >> i & 1]


def model_terms(t, base_rot, base_pos, q, nu, armature):
    """(M, b, link R, link p, joint axes, pivots) at one state, as the kernel
    forms them: FK by each link's path, composite inertias about p0, one
    Newton-Euler pass."""
    nj, nl = t["nj"], t["nl"]
    B = q.shape[0]
    n = 6 + nj
    Rj = lie.so3_exp(t["axis"] * q[..., None])
    R, p = [base_rot], [base_pos]
    for l in range(1, nl):  # each link walks its own path from the base
        Rl, pl = base_rot, base_pos
        for j in bits(t["anc"][l], nj):
            pl = pl + (Rl @ t["opos"][j][:, None])[..., 0]
            Rl = (Rl @ t["orot"][j]) @ Rj[:, j]
        R.append(Rl)
        p.append(pl)
    R, p = torch.stack(R, 1), torch.stack(p, 1)
    p0 = base_pos[:, None]
    par = t["parent"]
    c = p + (R @ t["com"][..., None])[..., 0]
    r = c - p0
    Iw = R @ t["inertia"] @ R.mT
    m = t["mass"]
    h = m[:, None] * r
    Ib = Iw - m[:, None, None] * (lie.hat(r) @ lie.hat(r))
    ax = (R[:, par] @ (t["orot"] @ t["axis"][..., None]))[..., 0]
    pv = p[:, par] + (R[:, par] @ t["opos"][..., None])[..., 0]
    S = torch.cat([cross(pv - p0, ax), ax], -1)

    def composite(x):  # x [B, nl, ...]: the sum over each link's subtree
        return torch.stack([sum(x[:, k] for k in bits(t["sub"][l], nl)) for l in range(nl)], 1)

    cm, ch, cI = composite(m.expand(B, nl)), composite(h), composite(Ib)
    sl, sa = S[..., :3], S[..., 3:]
    F = torch.cat([cm[:, 1:, None] * sl - cross(ch[:, 1:], sa),
                   cross(ch[:, 1:], sl) + (cI[:, 1:] @ sa[..., None])[..., 0]], -1)
    M = q.new_zeros(B, n, n)
    M[:, 0:3, 0:3] = cm[:, 0, None, None] * torch.eye(3, dtype=q.dtype)
    M[:, 0:3, 3:6] = -lie.hat(ch[:, 0])
    M[:, 3:6, 0:3] = lie.hat(ch[:, 0])
    M[:, 3:6, 3:6] = cI[:, 0]
    M[:, 0:6, 6:] = F.mT
    M[:, 6:, 0:6] = F
    for i in range(nj):
        for j in range(nj):
            lo, hi = min(i, j), max(i, j)
            if t["anc"][hi + 1] >> lo & 1:
                M[:, 6 + i, 6 + j] = (S[:, lo] * F[:, hi]).sum(-1)
        M[:, 6 + i, 6 + i] = M[:, 6 + i, 6 + i] + armature
    # Newton-Euler at zero acceleration, each link walking its path
    vb, wb, qd = nu[:, 0:3], nu[:, 3:6], nu[:, 6:]
    W = []
    for l in range(nl):
        w, al, pdd = wb, torch.zeros_like(wb), torch.zeros_like(wb)
        for j in bits(t["anc"][l], nj):
            d = p[:, j + 1] - p[:, par[j]]
            pdd = pdd + (cross(al, d) + cross(w, cross(w, d)))
            al = al + cross(w, ax[:, j]) * qd[:, j, None]
            w = w + ax[:, j] * qd[:, j, None]
        e = c[:, l] - p[:, l]
        cdd = pdd + (cross(al, e) + cross(w, cross(w, e)))
        f = m[l] * cdd
        f = f + torch.tensor([0.0, 0.0, GRAVITY], dtype=q.dtype) * m[l]
        nl_ = (Iw[:, l] @ al[..., None])[..., 0] + cross(w, (Iw[:, l] @ w[..., None])[..., 0])
        W.append(torch.cat([f, nl_ + cross(r[:, l], f)], -1))
    cW = composite(torch.stack(W, 1))
    Mnu = (M @ nu[..., None])[..., 0]
    b = torch.cat([cW[:, 0, 0:3], cW[:, 0, 3:6] + cross(wb, Mnu[:, 3:6]), (S * cW[:, 1:]).sum(-1)], -1)
    return M, b, Mnu, R, p, ax, pv


def model_cholesky_solve(A, rhs):
    """The kernel's warp solve: right-looking Cholesky of the lower triangle,
    then the forward and the backward substitution, column by column."""
    A, y = A.clone(), rhs.clone()
    n = A.shape[-1]
    for k in range(n):
        d = torch.sqrt(A[:, k, k])
        A[:, k, k] = d
        A[:, k + 1:, k] = A[:, k + 1:, k] / d[:, None]
        col = A[:, k + 1:, k]
        A[:, k + 1:, k + 1:] = A[:, k + 1:, k + 1:] - col[:, :, None] * col[:, None, :]
    for k in range(n):
        y[:, k] = y[:, k] / A[:, k, k]
        y[:, k + 1:] = y[:, k + 1:] - A[:, k + 1:, k] * y[:, k, None]
    for k in reversed(range(n)):
        y[:, k] = y[:, k] / A[:, k, k]
        y[:, :k] = y[:, :k] - A[:, k, :k] * y[:, k, None]
    return y


def model_substep(t, cfg, s: RB.RigidBodyState, q_cmd, h, f_ext):
    """One substep as the kernel takes it: (state, M, b, corners dropped)."""
    nj, nfeet, ncor = t["nj"], t["nfeet"], t["ncor"]
    pr = s.params
    M, b, Mnu, R, p, ax, pv = model_terms(t, s.base_rot, s.base_pos, s.q, s.nu, cfg.armature)
    p0 = s.base_pos[:, None, None]
    pts, J = [], []
    for i in range(nfeet):
        fl = t["flink"][i]
        fR = R[:, fl] @ t["frot"][i]
        fp = p[:, fl] + (R[:, fl] @ t["fpos"][i][:, None])[..., 0]
        pt = fp[:, None] + (fR[:, None] @ t["corners"][i][..., None])[..., 0]  # [B, ncor, 3]
        mask = torch.tensor([float(t["anc"][fl] >> j & 1) for j in range(nj)], dtype=s.q.dtype)
        cols = cross(ax[:, None], pt[:, :, None] - pv[:, None]) * mask[:, None]  # [B, ncor, nj, 3]
        lin = torch.eye(3, dtype=s.q.dtype).expand(pt.shape[:2] + (3, 3))
        J.append(torch.cat([lin, -lie.hat(pt - p0[:, 0]), cols.transpose(-1, -2)], -1))
        pts.append(pt)
    pts, J = torch.stack(pts, 1), torch.stack(J, 1)  # [B, nfeet, ncor, 3], [B, nfeet, ncor, 3, n]

    def per_corner(v):
        return v[:, None, None]

    pen = torch.clamp_min(-pts[..., 2], 0.0)
    act = (pen > 0.0).to(pen.dtype)
    xy = pts[..., 0:2]
    down = (act.amax(-1) > 0)[..., None, None]
    anchors0 = torch.where(down, s.anchors, xy)
    tau = per_corner(pr.anchor_relax_tau)[..., None]
    anchors0 = anchors0 + (xy - anchors0) * torch.where(tau > 0.0, h / torch.clamp_min(tau, 1e-6), 0.0)
    f0 = torch.cat([-per_corner(pr.contact_ks)[..., None] * (xy - anchors0) * act[..., None],
                    (per_corner(pr.contact_kp) * pen * act)[..., None]], -1)
    err = q_cmd - s.q
    imax, tmax = pr.servo_int_max[:, None], pr.tau_max[:, None]
    s_int = torch.minimum(torch.maximum(s.servo_int + pr.servo_ki[:, None] * h * err, -imax), imax)
    tau_j0 = torch.minimum(torch.maximum(pr.servo_kp[:, None] * err + s_int, -tmax), tmax)
    d_srv = pr.servo_kd + pr.joint_damping + h * pr.servo_kp
    tau0 = torch.cat([f_ext, torch.zeros_like(f_ext), tau_j0], -1)
    Msrv = M.clone()
    Msrv[:, 6:, 6:] += torch.diag_embed(h * d_srv[:, None].expand(-1, nj))
    Jr = J.reshape(J.shape[0], -1, J.shape[-1])  # rows 3 corner + x

    def solve(a):
        D = torch.stack([per_corner(pr.contact_kt + h * pr.contact_ks) * a] * 2
                        + [per_corner(pr.contact_kd + h * pr.contact_kp) * a], -1).reshape(Jr.shape[0], -1)
        f0a = (f0 * a[..., None]).reshape(D.shape)
        A = Msrv + h * (Jr.mT @ (D[..., None] * Jr)) + 1e-9 * torch.eye(Jr.shape[-1], dtype=M.dtype)
        rhs = Mnu + h * ((tau0 - b) + (Jr.mT @ f0a[..., None])[..., 0])
        x = model_cholesky_solve(A, rhs)
        return x, (f0a - D * (Jr @ x[..., None])[..., 0]).reshape(pts.shape)

    x1, fc1 = solve(act)
    act2 = act * (fc1[..., 2] > 0.0).to(act.dtype)
    changed = (act2 != act).flatten(1).any(-1)
    x2, fc2 = solve(act2)  # the kernel solves again only where a corner dropped
    x = torch.where(changed[:, None], x2, x1)
    fc = torch.where(changed[:, None, None, None], fc2, fc1)
    fz = torch.clamp_min(fc[..., 2], 0.0) * act2
    ft_raw = fc[..., 0:2]
    ft_foot = ft_raw.sum(-2)
    cap = pr.contact_mu[:, None] * fz.sum(-1)
    norm = torch.linalg.vector_norm(ft_foot, dim=-1)
    scale = torch.clamp_max(cap / torch.clamp_min(norm, 1e-9), 1.0)[..., None, None]
    fc = torch.cat([ft_raw * scale, fz[..., None]], -1)
    slip = (-(ft_foot / torch.clamp_min(norm, 1e-9)[..., None])[..., None, :]
            * ((1.0 - scale[..., 0]) * norm[..., None] / per_corner(pr.contact_ks) / 4.0)[..., None])
    anchors = torch.where((act2.amax(-1) > 0)[..., None, None] & (scale < 1.0), anchors0 + slip, anchors0)
    out = RB.RigidBodyState(lie.so3_exp(h * x[:, 3:6]) @ s.base_rot, s.base_pos + h * x[:, 0:3], s.q + h * x[:, 6:],
                            x, fc, anchors, s_int, pr)
    return out, M, b, int((act2 != act).sum())


def model_tick(cfg, model, s, q_cmd, dt, ext=None):
    """(state, [M, b and the corners dropped, a substep])."""
    t = unpack(model)
    f_ext = torch.zeros_like(s.base_pos) if ext is None else ext
    terms = []
    for _ in range(cfg.substeps):
        s, M, b, dropped = model_substep(t, cfg, s, q_cmd, dt / cfg.substeps, f_ext)
        terms.append((M, b, dropped))
    return s, terms


# --- on the CPU --------------------------------------------------------------------

KINDS = ("settled", "pushed", "airborne", "separating")


@pytest.fixture(scope="module")
def urdf():
    return TK.ergocub_urdf()


@pytest.fixture(scope="module")
def cpu_states(urdf):
    """{B: the four kinds of state at B items} in f64 on the CPU."""
    return {B: chip_smoke.rigid_kinds(urdf, B) for B in (1, 3)}


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_model_terms_match_autodiff(urdf, cpu_states, kind, B):
    """M and b of the kernel's closed forms against the twin's composite
    Jacobians and autodiff, f64."""
    s, _, _ = cpu_states[B][kind]
    cfg = RB.RigidBodyConfig()
    M, b, *_ = model_terms(unpack(urdf), s.base_rot, s.base_pos, s.q, s.nu, cfg.armature)
    lR, lp = TK.fk(urdf, s.q, s.base_rot, s.base_pos)
    assert rel_gap(M, RB.mass_matrix(urdf, lR, lp, cfg.armature)) < MODEL_RTOL
    assert rel_gap(b, RB.bias_forces(cfg, urdf, s.base_rot, s.base_pos, s.q, s.nu)) < MODEL_RTOL


@pytest.mark.parametrize("kind", KINDS)
def test_model_terms_on_a_sheared_base(urdf, cpu_states, kind):
    """A base rotation that f32 ticks have left off orthonormal (the sweep's
    states read |R^T R - I| ~ 2e-6): M is still the twin's, while the twin's
    autodiff differentiates the sheared FK (a joint then moves its subtree by
    R hat(u) R^-1, not by a rotation about the world axis R u), so b parts
    from the closed forms by a small fraction of the shear, and is theirs
    again for the orthonormalised rotation."""
    s, _, _ = cpu_states[3][kind]
    cfg = RB.RigidBodyConfig()
    shear = 2e-6 * torch.tensor([[0.3, -0.7, 0.2], [0.5, 0.1, -0.4], [-0.6, 0.8, 0.9]], dtype=torch.float64)
    sheared = (torch.eye(3, dtype=torch.float64) + shear) @ s.base_rot
    off = float((sheared.mT @ sheared - torch.eye(3, dtype=torch.float64)).abs().max())
    U, _, Vh = torch.linalg.svd(sheared)
    t = unpack(urdf)
    gaps = {}
    for name, R in (("sheared", sheared), ("orthonormal", U @ Vh)):
        M, b, *_ = model_terms(t, R, s.base_pos, s.q, s.nu, cfg.armature)
        lR, lp = TK.fk(urdf, s.q, R, s.base_pos)
        assert rel_gap(M, RB.mass_matrix(urdf, lR, lp, cfg.armature)) < MODEL_RTOL
        gaps[name] = rel_gap(b, RB.bias_forces(cfg, urdf, R, s.base_pos, s.q, s.nu))
    assert gaps["orthonormal"] < MODEL_RTOL
    assert MODEL_RTOL < gaps["sheared"] < 0.1 * off, (gaps, off)


@pytest.mark.parametrize("substeps", [1, 2])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_model_matches_the_twin(urdf, cpu_states, kind, B, substeps):
    """A whole tick: nu+, the corner forces, the anchors, the servo integral
    and the pose, f64; the separating state drops corners in the active-set
    pass and the airborne one touches nothing."""
    s, q_cmd, ext = cpu_states[B][kind]
    cfg = RB.RigidBodyConfig(substeps=substeps)
    want = RB._dynamics_step(cfg, urdf, s, q_cmd, DT, RB.SOLES, None, ext)
    got, terms = model_tick(cfg, urdf, s, q_cmd, DT, ext)
    gaps = chip_smoke.rigid_gaps(got, want)
    assert max(gaps.values()) < MODEL_RTOL, gaps
    if kind == "separating":
        assert terms[0][2] > 0
    if kind == "airborne":
        assert not bool(want.corner_forces.any())
    else:
        assert bool((want.corner_forces[..., 2] > 0).any())


def test_cpu_wrapper_is_the_twin(urdf, cpu_states):
    before = K6.launches
    cfg = RB.RigidBodyConfig()
    for kind in KINDS:
        s, q_cmd, ext = chip_smoke.rigid_moved(cpu_states[3][kind], "cpu", torch.float32)
        want = RB._dynamics_step(cfg, urdf, s, q_cmd, DT, RB.SOLES, None, ext)
        got = RB.dynamics_step(cfg, urdf, s, q_cmd, DT, ext_force_base=ext)
        assert all(torch.equal(g, w) for g, w in zip(got[:-1], want[:-1]))
        assert got.params is s.params
    assert K6.launches == before  # CPU tensors never reach the kernel
    with pytest.raises(ValueError, match="CUDA device"):
        RB._kernel_step(cfg, urdf, s, q_cmd, DT, RB.SOLES, None, ext)


def chain_model(nj: int) -> TK.RobotModel:
    """A serial chain of nj revolute joints with both soles on its last link."""
    eye = np.eye(3)
    return TK.RobotModel(
        joint_names=tuple(f"j{i}" for i in range(nj)), parent=np.arange(nj),
        axis=np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]] * nj)[:nj],
        origin_pos=np.tile([0.0, 0.0, -0.02], (nj, 1)), origin_rot=np.stack([eye] * nj),
        link_mass=np.full(nj + 1, 0.5), link_com=np.tile([0.0, 0.0, -0.01], (nj + 1, 1)),
        link_inertia=np.stack([1e-3 * eye] * (nj + 1)), frame_names=RB.SOLES, frame_link=np.array([nj, nj]),
        frame_pos=np.array([[0.0, 0.05, 0.0], [0.0, -0.05, 0.0]]), frame_rot=np.stack([eye] * 2))


@pytest.mark.parametrize("nj", [20, 27])
def test_plan_limits_and_the_raise_past_them(urdf, nj):
    """ergoCub fits in both dtypes; another tree, another dtype or a working
    set past shared memory has no launch, and the launcher then raises
    before it looks at the tensors' device."""
    assert urdf.nj == K6.NJ
    for dtype in (torch.float32, torch.float64):
        pl = K6.plan(K6.NJ, 2, 4, dtype)
        assert pl is not None and pl.threads == K6.THREADS and pl.smem_bytes <= K6.MAX_SMEM
    assert K6.plan(K6.NJ, 2, 4, torch.float32).smem_bytes == 24304  # the kernel refuses another size
    assert K6.plan(K6.NJ, 2, 4, torch.float16) is None
    assert K6.plan(K6.NJ, 2, 400, torch.float64) is None  # shared memory
    assert K6.plan(nj, 2, 4, torch.float32) is None
    model = chain_model(nj)
    q = torch.full((1, nj), 0.05, dtype=torch.float64)
    s = RB.initial_state(model, q, torch.eye(3, dtype=torch.float64)[None], torch.tensor([[0.0, 0.0, 1.5]]),
                         RB.RigidBodyConfig(), device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="no launch holds"):
        RB._kernel_step(RB.RigidBodyConfig(), model, s, q, DT, RB.SOLES, None, None)


# --- on the card -------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", chip_smoke.K6_BATCHES)
def test_kernel_matches_twin(card, urdf, B):
    """f32 within K6_GAP times the twin's own f32-vs-f64 gap (the largest over
    the four kinds, per field); f64 within K6_F64_RTOL; two
    launches bitwise equal (`chip_smoke.check_rigid_step` raises otherwise)."""
    chip_smoke.check_rigid_step(f"B={B}", urdf, B, device=card)


@pytest.mark.cuda
def test_launches_bitwise_equal_and_graph_replay(card, urdf):
    cfg = RB.RigidBodyConfig()
    s, q_cmd, ext = chip_smoke.rigid_cases(urdf, 256, card)["pushed"]
    first = RB._kernel_step(cfg, urdf, s, q_cmd, DT, RB.SOLES, None, ext)
    for _ in range(23):
        again = RB._kernel_step(cfg, urdf, s, q_cmd, DT, RB.SOLES, None, ext)
        assert all(torch.equal(a, b) for a, b in zip(again[:-1], first[:-1]))
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        RB._kernel_step(cfg, urdf, s, q_cmd, DT, RB.SOLES, None, ext)  # warm-up off the capture
        with torch.cuda.graph(graph, stream=stream):
            out = RB._kernel_step(cfg, urdf, s, q_cmd, DT, RB.SOLES, None, ext)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out[:-1], first[:-1]))


@pytest.mark.cuda
def test_graphed_rigid_period_counts_one_launch_a_tick(card, urdf):
    """The sweep's period graph (gz preset, rigid plant): one K6 launch a WBC
    tick, mpc_every a replay."""
    cfg = ergocub_gazebo_v1(rigid=RB.RigidBodyConfig())
    weights = convert.mann_weights_from_numpy(chip_smoke.synthetic_mann_numpy(), device=card)
    ctl = RL.WalkingController(cfg, urdf, weights, device=card)
    B, k = 4, cfg.mpc_every
    s = ctl.initial_state(B)
    zeros = torch.zeros(B, 3, device=card)
    inp = RL.TickInput(chip_smoke.joysticks(B, device=card), zeros, zeros)
    blk = RL.TickInput(*(a[:, None].expand(B, k, a.shape[-1]) for a in inp))
    ctl.run_episode_blocked(s, blk)  # the capture
    before = K6.launches
    for _ in range(2):
        ctl.run_episode_blocked(s, blk)
    torch.cuda.synchronize()
    assert K6.launches - before == 2 * k

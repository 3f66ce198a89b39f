"""Gauss-Newton SQP solve of the centroidal MPC, batch-first.

PyTorch counterpart of `cmw_tpu/cmpc/solver.py`. `CentroidalMPCSolver.solve`
takes `MPCParams` and a `WarmStart` whose tensors all lead with the batch
axis B and returns an `MPCSolution` of [B, ...] tensors; where JAX batches the
per-item solve with `vmap`, the port runs the whole batch at once. Where
JAX jits the solve with the solver static (`cmw_tpu/cmpc/solver.py:121`),
the port captures it: on the card `solve` replays the CUDA graph cached for
the config's value and the inputs' shapes (`runtime/cache.py`), so every
launch of the hand kernels below happens inside a graph; on the CPU, and
under `runtime.cache.disable_graphs()`, it runs eagerly. The solve:

  1. warm-started z0 (time-shifted forces, slot-matched positions);
  2. the KKT operator M = H + sigma I + A^T rho A, factored once per solve
     (quasi-Newton) or per SQP iteration (`refactor_every_sqp`):
     - Riccati branch (`kkt_impl` "auto"/"riccati", the default): the
       stage-wise factor of `cmpc/riccati.py`, applied with vector sweeps;
       each SQP iteration's ADMM loop, sweeps and constraint rows together,
       is one launch of the Riccati ADMM kernel (`ops/riccati_admm.py`) on the
       card and its plain twin, `qp.admm_solve` with `riccati_apply`, on the
       CPU;
     - dense branch (`kkt_impl="dense"`): J by `vmap(jacfwd)`, H = J^T J,
       M^-1 by the inverse kernel (`ops/spd_inverse.py`) or plain Cholesky,
       applied as a batched matmul or by the packed symv kernel;
  3. `sqp_iters` SQP iterations, each `admm_iters` ADMM iterations followed
     by the exact quadratic line search on the l1 merit. With
     `admm_impl="fused"` the dense branch runs each SQP iteration's ADMM loop
     as one launch of the fused ADMM kernel (`ops/admm_fused.py`) on the dense
     constraint matrix (`formulation.constraint_dense`).

Trace stages (`runtime/trace.py`) `mpc.factor`, `mpc.linearize`,
`mpc.admm` and `mpc.line_search` mark the phases: eagerly as host spans, and
in a graph captured with tracing on as device marks that every replay
carries. With tracing off they cost one flag check each, and a graph
captured then carries no marks.

Unknown option strings raise ValueError. The Riccati branch ignores
`admm_impl` and `kkt_dtype`, as in JAX, and so does the fused ADMM kernel.
`admm_impl="auto"` is the batched loop ("xla"), as in JAX. On the dense
branch's batched loop `kkt_dtype` picks the x-update's precision:
  - "f32": minv in the working dtype (the packed symv kernel where
    `xupdate_impl` asks for it);
  - "bf16": the first admm_iters - min(kkt_f32_tail, admm_iters) iterations
    multiply minv rounded to bf16 by rhs rounded to bf16, accumulating in the
    working dtype (JAX's dot_general with preferred_element_type), then the
    tail runs in the working dtype on the same state, the dense minv on both
    (no packed symv, as in JAX);
  - "auto": "f32" on every device. JAX resolves it to bf16 on a TPU and to
    f32 elsewhere, so off a TPU the two agree; the port's "auto" keeps the
    packed symv kernel, where JAX switches the packed symv off for any value
    but a literal "f32".
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, jvp, vjp, vmap

from cmw_tpu_torch.cmpc import formulation as F
from cmw_tpu_torch.cmpc.qp import ADMMState, admm_solve, spd_inverse
from cmw_tpu_torch.cmpc.riccati import riccati_factor
from cmw_tpu_torch.core.consts import constant_like, eye_like
from cmw_tpu_torch.ops import riccati_admm as ops_riccati_admm
from cmw_tpu_torch.ops import spd_inverse as ops_spd_inverse
from cmw_tpu_torch.ops.admm_fused import admm_fused
from cmw_tpu_torch.ops.symv import BLK, pack_symmetric
from cmw_tpu_torch.runtime import cache, trace

KKT_IMPLS = ("auto", "riccati", "dense")
INVERSE_IMPLS = ("auto", "pallas", "xla")
XUPDATE_IMPLS = ("auto", "dense", "symv")
ADMM_IMPLS = ("auto", "xla", "fused")
KKT_DTYPES = ("auto", "f32", "bf16")


class MPCSolution(NamedTuple):
    forces: torch.Tensor  # [B, T, nc, ncor, 3] world-frame corner forces / mass
    positions: torch.Tensor  # [B, nc, K, 3] adjusted contact positions
    states: torch.Tensor  # [B, N, 9] predicted (com, vcom, ang_mom)
    z: torch.Tensor  # [B, n] raw solution (warm start for the next tick)
    dual: torch.Tensor  # [B, m] ADMM dual (warm start)
    slack: torch.Tensor  # [B, m] ADMM auxiliary (warm start)
    prim_res: torch.Tensor  # [B] constraint violation (inf-norm)
    cost: torch.Tensor  # [B] 1/2 |r|^2


class WarmStart(NamedTuple):
    z: torch.Tensor  # [B, n]
    dual: torch.Tensor  # [B, m]
    slack: torch.Tensor  # [B, m]
    slot_act: torch.Tensor  # [B, nc, K] phase keys of the stored positions
    valid: torch.Tensor  # [B] {0., 1.}: 0 -> cold start


def _check(name: str, value: str, allowed: tuple) -> None:
    if value not in allowed:
        raise ValueError(f"MPCConfig.{name}={value!r}: expected one of {allowed}")


def _pad_to_blocks(M):
    """Zero-pad [B, n, n] to the next multiple of the symv block edge."""
    pad = -M.shape[-1] % BLK
    return torch.nn.functional.pad(M, (0, pad, 0, pad))


class CentroidalMPCSolver:
    """Stateless solver object: holds only the static MPCConfig."""

    def __init__(self, cfg: F.MPCConfig):
        _check("kkt_impl", cfg.kkt_impl, KKT_IMPLS)
        _check("inverse_impl", cfg.inverse_impl, INVERSE_IMPLS)
        _check("xupdate_impl", cfg.xupdate_impl, XUPDATE_IMPLS)
        _check("admm_impl", cfg.admm_impl, ADMM_IMPLS)
        _check("kkt_dtype", cfg.kkt_dtype, KKT_DTYPES)
        self.cfg = cfg
        self.use_riccati = cfg.kkt_impl in ("auto", "riccati")
        self.use_fused = not self.use_riccati and cfg.admm_impl == "fused"
        self.kkt_dtype = "f32" if cfg.kkt_dtype == "auto" else cfg.kkt_dtype

    # -- warm start -----------------------------------------------------------

    def cold_start(self, batch: int, *, device="cuda", dtype=torch.float32) -> WarmStart:
        cfg = self.cfg
        return WarmStart(
            z=torch.zeros((batch, cfg.n_vars), dtype=dtype, device=device),
            dual=torch.zeros((batch, cfg.n_con), dtype=dtype, device=device),
            slack=torch.zeros((batch, cfg.n_con), dtype=dtype, device=device),
            slot_act=torch.full((batch, cfg.n_contacts, cfg.n_slots), -1.0, dtype=dtype, device=device),
            valid=torch.zeros((batch,), dtype=dtype, device=device),
        )

    def _initial_z(self, params: F.MPCParams, warm: WarmStart):
        """Warm-started decision vector [B, n].

        Forces: previous solution shifted by one interval (receding horizon).
        Positions: previous slot value where the slot still refers to the same
        phase (matched on activation time), nominal otherwise.
        """
        cfg = self.cfg
        stage = params.stage
        dtype = warm.z.dtype
        warm_ok = warm.valid[:, None, None, None, None] > 0
        Fz, Pz = F.unpack_z(cfg, warm.z)
        F_shift = torch.cat([Fz[:, 1:], Fz[:, -1:]], dim=1)
        F_nom = F.nominal_force_guess(cfg, stage, dtype)
        F0 = torch.where(warm_ok, F_shift, F_nom)

        # slot matching on activation times: match[b, i, new slot, old slot]
        match = ((stage.slot_act[..., :, None] - warm.slot_act[..., None, :]).abs() < 0.5 * cfg.dt).to(dtype)
        match = match * stage.slot_valid[..., :, None]
        has_match = match.amax(dim=-1, keepdim=True)  # [B, nc, K, 1]
        P_matched = torch.einsum("bino,biox->binx", match, Pz)
        P0 = torch.where(warm_ok[..., 0] & (has_match > 0), P_matched, stage.slot_pos_nom.to(dtype))
        return F.pack_z(cfg, F0, P0)

    # -- the solve ------------------------------------------------------------

    def solve(self, params: F.MPCParams, warm: WarmStart) -> MPCSolution:
        """The solve, replayed from the graph cached for (config value,
        inputs' shapes) on the card; eagerly on the CPU."""
        return cache.graphed(("solve", self.cfg), self._solve, params, warm)

    def _solve(self, params: F.MPCParams, warm: WarmStart) -> MPCSolution:
        cfg = self.cfg
        z0 = self._initial_z(params, warm)
        dtype, device = z0.dtype, z0.device
        stage = params.stage
        warm_ok = warm.valid[:, None] > 0

        l, u, rho = F.constraint_bounds(cfg, stage, dtype)
        con_op = F.constraint_op(cfg, stage, dtype)

        def matvec(v):
            return F.op_matvec(cfg, con_op, v)

        def rmatvec(v):
            return F.op_rmatvec(cfg, con_op, v)

        def res_fn(zz):
            return F.residuals(cfg, params, zz)

        def grad_fn(zz):
            # grad of 1/2 |r|^2 = J^T r, one reverse-mode pass
            r, pullback = vjp(res_fn, zz)
            return pullback(r)[0]

        zc0 = torch.where(warm_ok, warm.slack, torch.clamp(matvec(z0), l, u))
        y0 = torch.where(warm_ok, warm.dual, torch.zeros_like(warm.dual))

        if self.use_riccati:
            lam_sig = cfg.levenberg + cfg.admm_sigma

            def hvp_at(z_lin, v):
                _, Jv = jvp(res_fn, (z_lin,), (v,))
                _, pullback = vjp(res_fn, z_lin)
                return pullback(Jv)[0] + cfg.levenberg * v

            def run_admm(fac, q, z, zc, y):
                return ops_riccati_admm.riccati_admm(
                    cfg, fac, con_op, q, l, u, rho, z, zc, y,
                    iters=cfg.admm_iters, sigma=cfg.admm_sigma, alpha=cfg.admm_alpha,
                )

            def linearize(z, z_lin, fac):
                g = grad_fn(z)
                return fac, g - hvp_at(z_lin, z)

            if cfg.refactor_every_sqp:
                def sqp_operator(z):
                    return linearize(z, z, riccati_factor(cfg, params, z, rho, lam_sig))
            else:
                with trace.stage("mpc.factor"):
                    fac0 = riccati_factor(cfg, params, z0, rho, lam_sig)

                def sqp_operator(z):
                    return linearize(z, z0, fac0)
        else:
            eye = eye_like(cfg.n_vars, z0)
            ata = F.ata_blockdiag(cfg, stage, rho, dtype)
            inv = ops_spd_inverse.spd_inverse if cfg.inverse_impl in ("auto", "pallas") else spd_inverse
            xupd = cfg.xupdate_impl
            if xupd == "auto":
                xupd = "symv" if device.type == "cuda" else "dense"
            # the fused kernel takes the dense minv; the bf16 x-update the dense one
            use_symv = xupd == "symv" and not self.use_fused and self.kkt_dtype == "f32"

            def res_item(p, zz):
                return F.residuals(cfg, p, zz)

            def gauss_newton(z):
                r = res_fn(z)
                J = vmap(jacfwd(res_item, argnums=1))(params, z)  # [B, nr, n]
                Jt = J.transpose(-1, -2)
                g = torch.matmul(Jt, r[..., None])[..., 0]
                H = torch.matmul(Jt, J) + cfg.levenberg * eye
                return g, H

            def factor(H):
                minv = inv((H + cfg.admm_sigma * eye + ata).contiguous())
                return minv, (pack_symmetric(_pad_to_blocks(minv)) if use_symv else None)

            if self.use_fused:
                A_dense = F.constraint_dense(cfg, stage, dtype)

                def run_admm(kkt, q, z, zc, y):
                    x, zc, y = admm_fused(
                        kkt[0], A_dense, q, l, u, rho, z, zc, y,
                        iters=cfg.admm_iters, sigma=cfg.admm_sigma, alpha=cfg.admm_alpha,
                    )
                    return ADMMState(x, zc, y), (matvec(x) - zc).abs().amax(dim=-1)
            else:
                tail = min(cfg.kkt_f32_tail, cfg.admm_iters) if self.kkt_dtype == "bf16" else cfg.admm_iters
                head = cfg.admm_iters - tail

                def run_admm(kkt, q, z, zc, y):
                    minv, packed = kkt
                    state = ADMMState(z, zc, y)
                    if head > 0:
                        # the exact product of the bf16-rounded operands: a
                        # matmul of two bf16 tensors would round its result
                        minv16 = minv.to(torch.bfloat16).to(minv.dtype)

                        def apply_bf16(rhs):
                            return torch.matmul(minv16, rhs.to(torch.bfloat16).to(rhs.dtype)[..., None])[..., 0]

                        state, _ = admm_solve(
                            None, q, matvec, rmatvec, l, u, rho, state, iters=head,
                            sigma=cfg.admm_sigma, alpha=cfg.admm_alpha, apply_fn=apply_bf16,
                        )
                    return admm_solve(
                        minv, q, matvec, rmatvec, l, u, rho, state,
                        iters=tail, sigma=cfg.admm_sigma, alpha=cfg.admm_alpha,
                        minv_packed=packed,
                    )

            def h_mv(H, z):
                return torch.matmul(H, z[..., None])[..., 0]

            if cfg.refactor_every_sqp:
                def sqp_operator(z):
                    g, H = gauss_newton(z)
                    return factor(H), g - h_mv(H, z)
            else:
                # quasi-Newton: one factorisation per solve; later iterations
                # reuse H0 with exact gradients
                with trace.stage("mpc.factor"):
                    _, H0 = gauss_newton(z0)
                    kkt0 = factor(H0)

                def sqp_operator(z):
                    return kkt0, grad_fn(z) - h_mv(H0, z)

        alphas = constant_like(tuple(cfg.line_search_alphas), z0)
        z, zc, y = z0, zc0, y0
        prim = None
        for _ in range(cfg.sqp_iters):
            with trace.stage("mpc.linearize"):
                kkt, q = sqp_operator(z)
            with trace.stage("mpc.admm"):
                state, prim = run_admm(kkt, q, z, zc, y)
            with trace.stage("mpc.line_search"):
                # globalisation: the residual is exactly quadratic in z, so the
                # merit along dz is exact from one jvp and one more residual:
                #   r(z + a dz) = r0 + a r1 + a^2 r2,  A(z + a dz) = az0 + a adz
                dz = state.x - z
                r0, r1 = jvp(res_fn, (z,), (dz,))
                r2 = res_fn(z + dz) - r0 - r1
                az0, adz = matvec(z), matvec(dz)
                a = alphas[:, None]  # [NA, 1] against [B, 1, ...] below
                r = r0[:, None] + a * r1[:, None] + (a * a) * r2[:, None]  # [B, NA, nr]
                az = az0[:, None] + a * adz[:, None]
                viol = torch.clamp(az - u[:, None], min=0.0) + torch.clamp(l[:, None] - az, min=0.0)
                merits = 0.5 * (r * r).sum(dim=-1) + cfg.merit_penalty * viol.sum(dim=-1)  # [B, NA]
                a_best = alphas[torch.argmin(merits, dim=-1)]
                z, zc, y = z + a_best[:, None] * dz, state.zc, state.y

        forces, positions = F.unpack_z(cfg, z)
        # zero out numerically tiny forces on inactive intervals
        act = stage.active.transpose(-1, -2)[..., None, None].to(dtype)
        forces = forces * act
        states = F.rollout(cfg, params, forces, positions)
        r = res_fn(z)
        return MPCSolution(
            forces=forces,
            positions=positions,
            states=states,
            z=z,
            dual=y,
            slack=zc,
            prim_res=prim,
            cost=0.5 * (r * r).sum(dim=-1),
        )

    def warm_from(self, params: F.MPCParams, sol: MPCSolution) -> WarmStart:
        return WarmStart(
            z=sol.z,
            dual=sol.dual,
            slack=sol.slack,
            slot_act=params.stage.slot_act,
            valid=torch.ones(sol.z.shape[:1], dtype=sol.z.dtype, device=sol.z.device),
        )

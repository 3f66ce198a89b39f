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
     (quasi-Newton) or per SQP iteration (`refactor_every_sqp`): the
     stage-wise factor of `cmpc/riccati.py`, applied with vector sweeps
     (`kkt_impl` "auto"/"riccati", the default);
  3. `sqp_iters` SQP iterations, each `admm_iters` ADMM iterations followed
     by the exact quadratic line search on the l1 merit.

Profiler spans `mpc.factor`, `mpc.linearize`, `mpc.admm` and
`mpc.line_search` mark the phases for `torch.profiler` (eager runs only: a
replay has no spans).

The benchmark's copy holds the Riccati branch alone, the one both presets
run: the dense KKT branch (`kkt_impl="dense"`, its hand-written inverse,
packed symv and fused ADMM kernels) was left out of it, and a config that
asks for it raises ValueError, as an unknown option string does. The
Riccati branch ignores `admm_impl`, `inverse_impl`, `xupdate_impl` and
`kkt_dtype`, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vjp
from torch.profiler import record_function

from portbench.reference.cmpc import formulation as F
from portbench.reference.cmpc.qp import ADMMState, admm_solve
from portbench.reference.cmpc.riccati import riccati_apply, riccati_factor
from portbench.reference.core.consts import constant_like
from portbench.reference.runtime import cache

KKT_IMPLS = ("auto", "riccati")  # the program's "dense" is not in this copy
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


class CentroidalMPCSolver:
    """Stateless solver object: holds only the static MPCConfig."""

    def __init__(self, cfg: F.MPCConfig):
        _check("kkt_impl", cfg.kkt_impl, KKT_IMPLS)
        _check("inverse_impl", cfg.inverse_impl, INVERSE_IMPLS)
        _check("xupdate_impl", cfg.xupdate_impl, XUPDATE_IMPLS)
        _check("admm_impl", cfg.admm_impl, ADMM_IMPLS)
        _check("kkt_dtype", cfg.kkt_dtype, KKT_DTYPES)
        self.cfg = cfg

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
        dtype = z0.dtype
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

        lam_sig = cfg.levenberg + cfg.admm_sigma

        def hvp_at(z_lin, v):
            _, Jv = jvp(res_fn, (z_lin,), (v,))
            _, pullback = vjp(res_fn, z_lin)
            return pullback(Jv)[0] + cfg.levenberg * v

        def run_admm(fac, q, z, zc, y):
            return admm_solve(
                None, q, matvec, rmatvec, l, u, rho, ADMMState(z, zc, y),
                iters=cfg.admm_iters, sigma=cfg.admm_sigma, alpha=cfg.admm_alpha,
                apply_fn=lambda r: riccati_apply(cfg, fac, r),
            )

        def linearize(z, z_lin, fac):
            g = grad_fn(z)
            return fac, g - hvp_at(z_lin, z)

        if cfg.refactor_every_sqp:
            def sqp_operator(z):
                return linearize(z, z, riccati_factor(cfg, params, z, rho, lam_sig))
        else:
            with record_function("mpc.factor"):
                fac0 = riccati_factor(cfg, params, z0, rho, lam_sig)

            def sqp_operator(z):
                return linearize(z, z0, fac0)
        alphas = constant_like(tuple(cfg.line_search_alphas), z0)
        z, zc, y = z0, zc0, y0
        prim = None
        for _ in range(cfg.sqp_iters):
            with record_function("mpc.linearize"):
                kkt, q = sqp_operator(z)
            with record_function("mpc.admm"):
                state, prim = run_admm(kkt, q, z, zc, y)
            with record_function("mpc.line_search"):
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

"""Batched push-recovery sweeps (BASELINE config 5).

PyTorch counterpart of `cmw_tpu/dist/sweep.py`. `run_sweep` builds B
perturbed push-recovery scenarios and runs the closed loop for all of them
as one batch (blocked episodes folding their telemetry, in chunks of `chunk`
items one after another), then reduces survival metrics. With `use_mesh`
each rank of an initialised `torch.distributed` process group runs its
contiguous slice of the same scenarios and the metrics are reduced across
the group (JAX's shard_map with pmean / pmax).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cmw_tpu_torch.runtime.loop import WalkingController, constant_inputs


def items_of(tree, idx):
    """Items idx of every tensor's batch axis in a (nested) NamedTuple such
    as a LoopState or a TickInput; None leaves and the plant's noise
    generator (one for the batch) as they are."""
    if isinstance(tree, torch.Tensor):
        return tree[idx]
    if isinstance(tree, tuple):
        return type(tree)(*(items_of(a, idx) for a in tree))
    return tree


def _linspace(start: float, stop: float, num: int, dtype, device):
    """jnp.linspace's formula: start (1 - s) + stop s at s = i / (num - 1),
    the endpoints exact. (XLA rewrites it and fuses its products where its
    compiler chooses, so JAX's values lie within ~2 f32 ulps of the scale of
    these, not bit for bit.)"""
    if num == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    step = torch.arange(num - 1, dtype=dtype, device=device) / (num - 1)
    return torch.cat([start * (1 - step) + stop * step, torch.full((1,), stop, dtype=dtype, device=device)])


def build_scenarios(
    ctl: WalkingController,
    batch: int,
    seconds: float,
    push_max: float,
    push_duration: float = 0.4,
    vx: float = 0.8,
    ramp: float = 0.0,
    push_t0: float = 0.6,
    *,
    dtype=torch.float32,
):
    """B push scenarios on the controller's device: (initial LoopState [B],
    TickInput [B, S, ...]). Magnitude in [-push_max, push_max], a window of
    `push_duration` s from `push_t0` s, the even items pushed along x, the
    odd along y; S the episode rounded to whole MPC periods.

    A short pulse (default 0.4 s) tests impulse recovery, absorbable by the
    contact forces alone when their authority allows; a sustained push
    (>= 1.5 s) holds the ZMP at the support boundary for longer than force
    authority can bridge, the regime in which online footstep adjustment
    (against pinned footsteps) separates. `ramp` > 0 slews the joystick from
    0 to vx over that many seconds (a step command lurches the rigid plant)."""
    cfg, dev = ctl.cfg, ctl.device
    S = int(round(seconds / cfg.wbc_dt))
    S = max(cfg.mpc_every, S - S % cfg.mpc_every)  # whole MPC periods, for the blocked episode
    base = constant_inputs(S, (vx, 0.0, 1.0, 0.0), dtype, batch=batch, device=dev)
    if ramp > 0:
        tr = torch.clamp(torch.arange(S, dtype=dtype, device=dev) * cfg.wbc_dt / ramp, 0.0, 1.0)
        ones = torch.ones_like(tr)
        base = base._replace(joypad=base.joypad * torch.stack([tr, tr, ones, ones], dim=1))
    mags = _linspace(-push_max, push_max, batch, dtype, dev)
    even = torch.arange(batch, device=dev) % 2 == 0
    dirs = torch.stack([even, ~even, torch.zeros_like(even)], dim=-1).to(dtype)  # [B, 3]
    # the window's ends truncated, as JAX computes them
    i0 = int(push_t0 / cfg.wbc_dt)
    i1 = int((push_t0 + push_duration) / cfg.wbc_dt)
    win = torch.zeros(S, dtype=dtype, device=dev)
    win[i0:i1] = 1.0
    push = win[None, :, None] * mags[:, None, None] * dirs[:, None, :]
    return ctl.initial_state(batch, dtype=dtype), base._replace(ext_force=push)


def fold(acc, tel):
    """The sweep's per-tick reduction of a scenario's Telemetry [B, ...]
    into (supp_dev, z_dev, track_err, finite, up_min, bz_min, z0) [B]. At
    module level, closing over nothing: every chunk and every sweep call
    keys to one period graph (`run_episode_fold`)."""
    lat, dz, trk, fin, up, bz, zz0 = acc
    com = tel.com_mpc
    # the fall signal is the CoM leaving the support, not world-frame
    # drift: a push recovered by sidestepping moves the CoM far in the
    # world while it stays balanced over the stance feet
    fc = tel.foot_contact
    w = fc / torch.clamp_min(fc.sum(-1, keepdim=True), 1e-6)
    supp = (w[..., None] * tel.foot_pos_des).sum(1)
    rel = torch.linalg.vector_norm(com[:, 0:2] - supp[:, 0:2], dim=-1)
    # kinematic infeasibility: the commanded robot's FK CoM cannot follow
    # the centroidal model's
    track = torch.linalg.vector_norm(com[:, 0:2] - tel.com_meas[:, 0:2], dim=-1)
    return (
        torch.maximum(lat, rel),
        torch.maximum(dz, (com[:, 2] - zz0).abs()),
        torch.maximum(trk, track),
        fin & torch.isfinite(com).all(-1) & torch.isfinite(tel.base_act_up),
        # the physical plant's fall signals (constant on the kinematic plant)
        torch.minimum(up, tel.base_act_up),
        torch.minimum(bz, tel.base_act_pos[:, 2]),
        zz0,
    )


def _episode_metrics(ctl: WalkingController, s0, inputs, chunk: int):
    """Per-scenario survival metrics, each [b], by folding the telemetry of
    blocked episodes (O(1) telemetry memory), `chunk` items at a time:
    (supp_dev, z_dev, track_err, finite, up_min, bz_min, zb0)."""
    z0 = s0.x9[:, 2]  # initial CoM height
    # initial physical base height: the kinematic plant carries no rigid body,
    # and JAX's unsunk one there sits at the commanded base
    zb0 = (s0.base_pos if s0.rb is None else s0.rb.base_pos)[:, 2]

    def one(s, inp, zz0):
        zeros = torch.zeros_like(zz0)
        acc0 = (zeros, zeros, zeros, torch.ones_like(zz0, dtype=torch.bool), torch.ones_like(zz0),
                torch.full_like(zz0, 10.0), zz0)
        _, acc = ctl.run_episode_fold(s, inp, fold, acc0)
        return acc[:6]

    b = z0.shape[0]
    if chunk and b > chunk:
        if b % chunk:
            raise ValueError(f"batch {b} must divide into chunks of {chunk}")
        parts = [one(items_of(s0, slice(c, c + chunk)), items_of(inputs, slice(c, c + chunk)), z0[c:c + chunk])
                 for c in range(0, b, chunk)]
        return tuple(torch.cat(p) for p in zip(*parts)) + (zb0,)
    return one(s0, inputs, z0) + (zb0,)


# fall thresholds (cmw_tpu/dist/sweep.py:131-139; a healthy walk keeps
# supp_dev < 0.15, z_dev < 0.05, track_err < 0.07, and falls blow past all)
SUPP_DEV_MAX = 0.4
Z_DEV_MAX = 0.25
TRACK_ERR_MAX = 0.15
# the rigid plant's: a standing or walking robot keeps its base tilt under
# ~25 deg and never drops its base by 25 %
UP_MIN = 0.9
BASE_Z_FRAC_MIN = 0.75


def _shard_metrics(ctl: WalkingController, s0, inputs, with_axis: bool, chunk: int = 0,
                   up_thresh: float = UP_MIN, model_guards: bool = True):
    """(survived [b] or, with_axis, [world b], stats {name: 0-d tensor}) of
    this process's scenarios; with_axis reduces the stats over the process
    group (means of equal shards as sum / world, maxima with MAX) and
    gathers the survived mask in rank order."""
    supp_dev, z_dev, track_err, finite, up_min, bz_min, zb0 = _episode_metrics(ctl, s0, inputs, chunk)
    if ctl.cfg.rigid is not None:
        # the plant gives the honest fall signal: the physical base tips over
        # or collapses; the model-side criteria stay as guards. Commanded-
        # walking sweeps pass up_thresh=0.7, model_guards=False: healthy
        # walking at the operating point tilts to ~35 deg and its capture
        # steps run the desired feet ahead of the CoM
        survived = finite & (up_min > up_thresh) & (bz_min > BASE_Z_FRAC_MIN * zb0)
        if model_guards:
            survived = survived & (supp_dev < SUPP_DEV_MAX) & (z_dev < Z_DEV_MAX)
    else:
        survived = finite & (supp_dev < SUPP_DEV_MAX) & (z_dev < Z_DEV_MAX) & (track_err < TRACK_ERR_MAX)
    stats = {
        "survival_rate": survived.to(torch.float32).mean(),
        "mean_supp_dev": supp_dev.mean(),
        "max_supp_dev": supp_dev.max(),
        "max_track_err": track_err.max(),
    }
    if with_axis:
        world = dist.get_world_size()
        for name in ("survival_rate", "mean_supp_dev"):
            dist.all_reduce(stats[name])
            stats[name] = stats[name] / world
        for name in ("max_supp_dev", "max_track_err"):
            dist.all_reduce(stats[name], op=dist.ReduceOp.MAX)
        parts = [torch.empty_like(survived, dtype=torch.uint8) for _ in range(world)]
        dist.all_gather(parts, survived.to(torch.uint8))
        survived = torch.cat(parts).bool()
    return survived, stats


def run_sweep(
    ctl: WalkingController,
    batch: int,
    seconds: float,
    push_max: float = 2.0,
    use_mesh: bool = False,
    chunk: int = 512,
    per_scenario: bool = False,
    push_duration: float = 0.4,
    vx: float = 0.8,
    ramp: float = 0.0,
    push_t0: float = 0.6,
    up_thresh: float = UP_MIN,
    model_guards: bool = True,
) -> dict:
    """The sweep's summary: survival and support-deviation statistics, the
    recoverable-push radius along x and y, and with per_scenario each
    scenario's push and survival. use_mesh needs an initialised process
    group: each rank runs batch / world scenarios and every rank returns
    the same summary."""
    if use_mesh:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("use_mesh=True needs an initialised torch.distributed process group "
                               "(for example one started by torchrun)")
        world, rank = dist.get_world_size(), dist.get_rank()
        if batch % world:
            raise ValueError(f"batch {batch} must divide over {world} ranks")
    s0, inputs = build_scenarios(ctl, batch, seconds, push_max, push_duration, vx, ramp, push_t0)
    if use_mesh:
        mine = slice(rank * batch // world, (rank + 1) * batch // world)
        s0, inputs = items_of(s0, mine), items_of(inputs, mine)
    survived, stats = _shard_metrics(ctl, s0, inputs, use_mesh, chunk, up_thresh, model_guards)
    out = {
        "batch": batch,
        "survival_rate": round(float(stats["survival_rate"]), 3),
        "mean_supp_dev": round(float(stats["mean_supp_dev"]), 4),
        "max_supp_dev": round(float(stats["max_supp_dev"]), 4),
        "survived": int(survived.sum()),
    }
    surv = survived.cpu().numpy()
    mags = np.linspace(-push_max, push_max, batch)
    isx = np.arange(batch) % 2 == 0
    # the largest |push| below which every weaker push along the same axis
    # survived: the recoverable-push radius, which the paper's step
    # adjustment claims to grow
    for dname, m in (("x", isx), ("y", ~isx)):
        lim = 0.0
        for a, s in sorted(zip(np.abs(mags[m]), surv[m])):
            if not s:
                break
            lim = a
        out[f"recoverable_push_{dname}"] = round(float(lim), 3)
    if per_scenario:
        out["push_mags"] = [round(float(v), 3) for v in mags]
        out["push_dirs"] = ["x" if v else "y" for v in isx]
        out["survived_mask"] = [bool(v) for v in surv]
    return out

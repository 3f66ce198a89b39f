"""The rigid plant's control tick, every substep of every item in one kernel (K6).

Replaces no TPU kernel: the JAX package runs the plant's substep scan as XLA
(`cmw_tpu/sim/rigid_body.py` `dynamics_step`). Per item it computes what
`sim/rigid_body._dynamics_step` computes (`cfg.substeps` velocity-implicit
substeps of dt / substeps), with the autodiff terms replaced by their closed
forms:

  - the mass matrix by the composite-rigid-body algorithm, every link's
    spatial inertia taken about the base origin in the world frame, so that a
    subtree's composite is a plain sum;
  - the bias forces by one Newton-Euler pass at zero acceleration, plus the
    term w_base x (M nu)[3:6] that the plant's exponential chart adds to the
    Newton-Euler bias (`rigid_body.bias_forces` differentiates M(x) in a chart
    whose rotation rates are world angular velocities only at x = 0).

`rigid_step` launches `csrc/rigid_step.cu` (see the note at the top of that
file) on CUDA tensors, and raises on any other device or where `plan` holds
no launch for the model's sizes. It takes tensors and returns tensors: the
caller, `sim/rigid_body.dynamics_step`, runs the twin
`rigid_body._dynamics_step` on CPU tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from cmw_tpu_torch.core import consts
from cmw_tpu_torch.ops import _build

ENTRIES = {torch.float32: "cmw_rigid_step_f32", torch.float64: "cmw_rigid_step_f64"}
THREADS = 256  # one block an item
NJ = 26  # the joints of the one tree the kernel is built for (ergoCub)
MAX_SMEM = 232448  # shared memory one H100 block may use
N_PARAMS = 12  # RigidDynParams' fields, in their order
launches = 0  # kernel launches in this process, one per call


class Plan(NamedTuple):
    """The launch the kernel takes for its sizes (`plan` in the source)."""

    threads: int
    smem_bytes: int


def float_table_len(nj: int, nfeet: int, ncor: int) -> int:
    """The model's float table: axis, origin_pos [nj, 3], origin_rot [nj, 3, 3],
    link_mass [nl], link_com [nl, 3], link_inertia [nl, 3, 3] (nl = nj + 1
    links), each sole frame's rotation [3, 3] and offset [3], the corners
    [nfeet, ncor, 3]."""
    return 15 * nj + 13 * (nj + 1) + 12 * nfeet + 3 * nfeet * ncor


def work_len(nj: int, nfeet: int, ncor: int) -> int:
    """Elements of an item's working set in shared memory (the kernel's
    `Layout`, in the same order)."""
    n, nl, ncr = 6 + nj, nj + 1, nfeet * ncor
    state = 9 + 3 + nj + n + 3 * ncr + 2 * ncr + nj + nj + 3 + N_PARAMS
    links = 9 * nj + 12 * nl + 20 * nl + 12 * nl
    joints = 6 * nj + 12 * nj
    dense = 2 * n * n + 4 * n
    contact = ncr * (3 + 3 * n + 3 + 3 + 2 + 2)
    return state + links + joints + dense + contact + 8


@functools.cache
def plan(nj: int, nfeet: int, ncor: int, dtype: torch.dtype) -> Plan | None:
    """The kernel's launch for a tree of nj joints with nfeet soles of ncor
    corners, in dtype, or None where none holds them: the kernel is built
    for nj = NJ alone, and the working set must fit one block's shared
    memory. Decided from the sizes alone."""
    if dtype not in ENTRIES or nj != NJ or nfeet < 1 or ncor < 1:
        return None
    elem = torch.empty((), dtype=dtype).element_size()
    ints = nj + 2 * (nj + 1) + nfeet
    smem = 8 * ints + elem * (float_table_len(nj, nfeet, ncor) + work_len(nj, nfeet, ncor))
    return Plan(THREADS, smem) if smem <= MAX_SMEM else None


def _masks(model) -> tuple[list[int], list[int]]:
    """Per link l: the joints on the path base -> l (bit j), and the links of
    l's subtree, itself included (bit k)."""
    nj = model.nj
    anc = [0] * (nj + 1)
    for j in range(nj):
        anc[j + 1] = anc[int(model.parent[j])] | 1 << j
    sub = [1 << l for l in range(nj + 1)]
    for l in range(1, nj + 1):  # link l is in the base's subtree and in that of each joint's child on its path
        sub[0] |= 1 << l
        for j in range(nj):
            if anc[l] >> j & 1:
                sub[j + 1] |= 1 << l
    return anc, sub


@functools.cache
def _tables(model, sole_frames: tuple, corner_table: tuple) -> tuple[tuple, tuple]:
    """(floats, ints) of the model as the kernel reads them (see
    `float_table_len`; ints: parent [nj], the two masks [nl] each, each sole
    frame's link [nfeet])."""
    fi = [model.frame_index(f) for f in sole_frames]
    parts = (model.axis, model.origin_pos, model.origin_rot, model.link_mass, model.link_com, model.link_inertia,
             model.frame_rot[fi], model.frame_pos[fi], np.asarray(corner_table))
    floats = tuple(float(v) for a in parts for v in np.asarray(a, dtype=np.float64).ravel())
    anc, sub = _masks(model)
    ints = tuple(int(v) for v in model.parent) + tuple(anc) + tuple(sub) + tuple(int(model.frame_link[i]) for i in fi)
    return floats, ints


def rigid_step(model, sole_frames: tuple, corners_local, state: tuple, params, q_cmd, ext_force_base, *,
               substeps: int, h: float, armature: float) -> tuple:
    """`substeps` velocity-implicit substeps of h of the rigid plant, on the
    card: the soles' frame names and their corners_local [nfeet, ncor, 3] (in
    the sole frame); state = (base_rot [B, 3, 3], base_pos [B, 3], q [B, nj],
    nu [B, 6 + nj], corner_forces [B, nfeet, ncor, 3], anchors [B, nfeet,
    ncor, 2], servo_int [B, nj]), params [B, N_PARAMS] (RigidDynParams'
    fields in order), q_cmd [B, nj], ext_force_base [B, 3] or None -> the
    state's seven tensors after the tick. float32 or float64."""
    cl = np.asarray(corners_local, dtype=np.float64)
    nfeet, ncor = cl.shape[0], cl.shape[1]
    nj, q = model.nj, state[2]
    pl = plan(nj, nfeet, ncor, q.dtype)
    if pl is None:
        raise ValueError(f"rigid_step: no launch holds nj={nj}, {nfeet} soles of {ncor} corners in {q.dtype}: the "
                         f"kernel is built for nj = {NJ} in {list(ENTRIES)}, within one block's shared memory")
    B, n = q.shape[0], 6 + nj
    ins = tuple(t.contiguous() for t in (*state, params, q_cmd))
    ext = None if ext_force_base is None else ext_force_base.contiguous()
    want = ((B, 3, 3), (B, 3), (B, nj), (B, n), (B, nfeet, ncor, 3), (B, nfeet, ncor, 2), (B, nj), (B, N_PARAMS),
            (B, nj))
    if len(ins) != len(want) or any(tuple(t.shape) != s for t, s in zip(ins, want)) or (
            ext is not None and tuple(ext.shape) != (B, 3)):
        raise ValueError(f"rigid_step: shapes {[tuple(t.shape) for t in ins]}, expected {list(want)} and ext (B, 3)")
    tensors = ins + (() if ext is None else (ext,))
    if q.device.type != "cuda" or any(t.device != q.device or t.dtype != q.dtype for t in tensors):
        raise ValueError(f"rigid_step: every tensor on one CUDA device in {q.dtype}, got "
                         f"{[(str(t.device), t.dtype) for t in tensors]}")
    floats, ints = _tables(model, tuple(sole_frames), tuple(map(tuple, cl.reshape(-1, 3).tolist())))
    ft, it = consts.constant_like(floats, q), consts.device_constant(ints, q.device, torch.int64)
    outs = tuple(q.new_empty(s) for s in want[:7])
    if B > 0:
        fn = _build.kernel(ENTRIES[q.dtype], 19, 6, 0, 2)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = fn(ft.data_ptr(), it.data_ptr(), *(t.data_ptr() for t in ins), None if ext is None else ext.data_ptr(),
                      *(t.data_ptr() for t in outs), B, nj, nfeet, ncor, substeps, pl.smem_bytes, h, armature, stream)
        _build.check("rigid_step", code)
        global launches
        launches += 1
    return outs

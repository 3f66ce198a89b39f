"""Port parity for the contact-plan functions of `cmw_tpu_torch.core.contacts`
that the MANN -> MPC tick runs (phase queries, merge, write-back, timeline
-> plan) vs `jax.vmap` of `cmw_tpu.core.contacts`, on the same numpy inputs.
These functions select, compare and take minima; the port must give the
JAX answer exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.core import contacts as jcon
from cmw_tpu_torch import convert
from cmw_tpu_torch.core import contacts as tcon

torch.set_num_threads(2)

# per item: a gait and a time. Item 0 at 1.02 s has its left foot swinging
# (lift at 1.0 s); item 3's time lies exactly on a phase boundary (1.7 s)
GAITS = [dict(), dict(first_swing=1, step_length=0.15), dict(t_first_lift=0.5, single_support=0.4),
         dict(double_support=0.3, n_steps=4)]
TIMES = np.array([1.02, 1.3, 0.75, 1.7], np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _plans(seed, gaits=GAITS):
    """Batched JAX plans [B, nc, P] from the gaits, poses perturbed."""
    rng = np.random.default_rng(seed)
    plans = [_np(jcon.make_alternating_gait(**kw)) for kw in gaits]
    plan = jax.tree_util.tree_map(lambda *a: np.stack(a), *plans)
    pos = plan.pos + 0.01 * rng.standard_normal(plan.pos.shape).astype(np.float32)
    return plan._replace(pos=pos * plan.valid[..., None])


def _same(got, want):
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("query", ["active_phase", "next_phase", "present_phase"])
@pytest.mark.parametrize("t_kind", ["float", "tensor"])
def test_phase_queries_match_jax(query, t_kind):
    """Index and flag per contact, at a time per item (a tensor [B]) or one
    float for the batch; then gather_phase at those indices."""
    jplan = _plans(0)
    tplan = convert.plan_from_numpy(jplan, device="cpu")
    if t_kind == "float":
        want = jax.vmap(getattr(jcon, query), in_axes=(0, None))(jplan, 1.3)
        got = getattr(tcon, query)(tplan, 1.3)
    else:
        want = jax.vmap(getattr(jcon, query))(jplan, jnp.asarray(TIMES))
        got = getattr(tcon, query)(tplan, torch.tensor(TIMES))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gathered = tcon.gather_phase(tplan, got[0])
    want_g = jax.vmap(jcon.gather_phase)(jplan, want[0])
    for g, w in zip(gathered, want_g):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ties_take_the_first_phase():
    """An empty plan: no phase is active, so every argmax is over zeros and
    returns the first index (0; present_phase, reversed, the last)."""
    jplan = _np(jcon.empty_plan(2, 8))
    tplan = tcon.empty_plan(2, 8, device="cpu")
    for query in ("active_phase", "next_phase", "present_phase"):
        want = getattr(jcon, query)(jplan, 0.5)
        got = getattr(tcon, query)(tplan, 0.5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    idx, flag = tcon.active_phase(tplan, 0.5)
    assert idx.tolist() == [0, 0] and flag.tolist() == [0.0, 0.0]


def _timeline(B=4, S=41, nc=2, seed=1):
    """A sampled contact timeline [B, S, nc]: item 0 alternates every 3
    samples on the left (more phases than P), item 1 has its left foot never
    down, item 2 ends in an open phase on both feet, item 3 is random."""
    rng = np.random.default_rng(seed)
    flags = np.ones((B, S, nc), np.float32)
    flags[0, :, 0] = (np.arange(S) // 3) % 2 == 0
    flags[1, :, 0] = 0.0
    flags[2, 10:20, 1] = 0.0
    flags[3] = rng.random((S, nc)) < 0.7
    times = (0.3 + 0.02 * np.arange(S, dtype=np.float32))[None].repeat(B, 0) + np.float32(0.06) * np.arange(B)[:, None]
    pos = rng.standard_normal((B, S, nc, 3)).astype(np.float32)
    rot = np.broadcast_to(np.eye(3, dtype=np.float32), (B, S, nc, 3, 3)).copy()
    rot[..., 0, 1] = rng.standard_normal((B, S, nc))
    return flags, times.astype(np.float32), pos, rot


@pytest.mark.parametrize("P", [4, 16])
def test_plan_from_timeline_matches_jax(P):
    """[B, S, nc] timelines into plans: with P = 4 the alternating foot has
    more phases than slots, and the later ones are dropped, as in JAX; a
    phase holding the last sample stays open (deact = BIG_TIME)."""
    flags, times, pos, rot = _timeline()
    want = jax.vmap(lambda *a: jcon.plan_from_timeline(*a, P=P))(*map(jnp.asarray, (flags, times, pos, rot)))
    got = tcon.plan_from_timeline(*map(torch.tensor, (flags, times, pos, rot)), P=P)
    _same(got, want)
    n_left = int(((flags[0, 1:, 0] > 0) & (flags[0, :-1, 0] == 0)).sum() + flags[0, 0, 0])
    assert n_left > 4 and float(got.valid[0, 0].sum()) == min(P, n_left)
    assert float(got.deact[2, 1, 0]) < tcon.BIG_TIME and float(got.deact[2, 1, 1]) == tcon.BIG_TIME  # open at the end
    assert float(got.valid[1, 0].sum()) == 0.0


def test_merge_plans_matches_jax():
    """The MANN plan (from a timeline starting at t) merged into the previous
    MPC plan at t, per item: item 0's left foot swings at t in both plans, so
    the old plan's last stance phase is kept in the last slot; the others
    hold the current phase's MPC pose with the MANN timing."""
    mpc = _plans(2)
    flags, _, pos, rot = _timeline(S=41, seed=3)
    flags[0, :, 0] = 0.0  # left foot swinging from t on
    times = TIMES[:, None] + np.float32(0.02) * np.arange(41, dtype=np.float32)
    mann = _np(jax.vmap(jcon.plan_from_timeline)(*map(jnp.asarray, (flags, times, pos, rot))))
    want = jax.vmap(jcon.merge_plans)(mann, mpc, jnp.asarray(TIMES))
    got = tcon.merge_plans(convert.plan_from_numpy(mann, device="cpu"), convert.plan_from_numpy(mpc, device="cpu"),
                           torch.tensor(TIMES))
    _same(got, want)
    # the swinging foot keeps its previous stance phase in the last slot
    assert float(got.valid[0, 0, -1]) == 1.0 and float(got.deact[0, 0, -1]) <= TIMES[0]
    snapped = tcon.snap_to_grid(got, 0.06)
    _same(snapped, jax.vmap(lambda p: jcon.snap_to_grid(p, 0.06))(want))


def test_write_back_adjusted_matches_jax():
    """Adjusted slot positions [B, nc, K, 3] written into the phases from the
    first one still relevant at t0, where the slot is valid."""
    rng = np.random.default_rng(4)
    jplan = _plans(5)
    K = 4
    slot_pos = rng.standard_normal((len(GAITS), 2, K, 3)).astype(np.float32)
    slot_valid = (rng.random((len(GAITS), 2, K)) < 0.7).astype(np.float32)
    want = jax.vmap(lambda p, t, sp, sv: jcon.write_back_adjusted(p, t, K, sp, sv))(
        jplan, jnp.asarray(TIMES), jnp.asarray(slot_pos), jnp.asarray(slot_valid))
    got = tcon.write_back_adjusted(convert.plan_from_numpy(jplan, device="cpu"), torch.tensor(TIMES), K,
                                   torch.tensor(slot_pos), torch.tensor(slot_valid))
    _same(got, want)
    assert not np.array_equal(got.pos.numpy(), jplan.pos)


def test_plan_sizes_match_jax():
    """ContactPlan.num_contacts / num_phases (cmw_tpu/core/contacts.py:43-49):
    the last two dims of `act`, for one plan and a batch of them."""
    jplan = jcon.make_alternating_gait(n_steps=4)
    tplan = convert.plan_from_numpy(_np(jplan), device="cpu")
    assert (tplan.num_contacts, tplan.num_phases) == (jplan.num_contacts, jplan.num_phases) == (2, 16)
    jbatch = _plans(0)
    tbatch = convert.plan_from_numpy(jbatch, device="cpu")
    assert (tbatch.num_contacts, tbatch.num_phases) == (jplan.num_contacts, jplan.num_phases)
    assert tcon.empty_plan(3, 8, device="cpu").num_phases == jcon.empty_plan(3, 8).num_phases == 8

"""WalkingController's value identity (the graph cache's key), against JAX's.

The contract of tests/test_controller_identity.py, whose controllers load
the shipped MANN file (absent here), on the synthetic MANN weights
(`chip_smoke.synthetic_mann_numpy`) through both packages: controllers hash
and compare by the frozen WalkingConfig's value plus the model's and the
weights' identity, never by their own identity, which CPython reuses after a
controller dies (it aliased the two arms of `sweep --ablation` to one
executable in JAX). For each pair the port answers as `cmw_tpu`'s
`__eq__` / `__hash__` answer; in the port the pairs key the graph cache
(`runtime/cache.py`) the same way."""

import jax
import jax.numpy as jnp
import pytest

import chip_smoke
from cmw_tpu.cmpc.formulation import no_adjust as j_no_adjust
from cmw_tpu.core import kinematics as JK
from cmw_tpu.mann import network as JN
from cmw_tpu.runtime.config import ergocub_gazebo_v1 as j_preset
from cmw_tpu.runtime.loop import WalkingController as JController
from cmw_tpu_torch import convert
from cmw_tpu_torch.cmpc.formulation import no_adjust as t_no_adjust
from cmw_tpu_torch.core import kinematics as TK
from cmw_tpu_torch.runtime import cache
from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1 as t_preset
from cmw_tpu_torch.runtime.loop import WalkingController as TController

W = chip_smoke.synthetic_mann_numpy()


def pairs(Controller, preset, no_adjust, model, model2, weights):
    """(name, a, b) of the contract's pairs; a is the same base controller."""
    a = Controller(preset(), model, weights)
    return [
        ("same value, same objects", a, Controller(preset(), model, weights)),
        ("the no_adjust ablation pair", a, Controller(preset(mpc=no_adjust(preset().mpc)), model, weights)),
        ("another model object", a, Controller(preset(), model2, weights)),
        ("an unrelated type", a, object()),
    ]


@pytest.fixture(scope="module")
def both():
    jw = JN.MANNWeights(**jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), W))
    tw = convert.mann_weights_from_numpy(W, device="cpu")
    jp = pairs(JController, j_preset, j_no_adjust, JK.ergocub_approx(), JK.ergocub_approx(), jw)
    tp = pairs(lambda *a: TController(*a, device="cpu"), t_preset, t_no_adjust, TK.ergocub_approx(),
               TK.ergocub_approx(), tw)
    return jp, tp


@pytest.mark.parametrize("i", range(4))
def test_controller_identity_matches_jax(both, i):
    (name, ja, jb), (_, ta, tb) = both[0][i], both[1][i]
    assert (ta == tb) == (ja == jb), name
    assert (ta != tb) == (ja != jb), name
    if ja == jb:
        assert hash(ta) == hash(tb) and hash(ja) == hash(jb), name
    # the cache keys the pair as the controllers compare
    if isinstance(tb, TController):
        same_key = cache.key(("wbc_stage", ta)) == cache.key(("wbc_stage", tb))
        assert same_key == (ja == jb), name

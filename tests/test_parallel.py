"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Covers the previously untested parallel layer (SURVEY §2 parallelism
table, comm-backend row): mesh construction, the dp×tp-sharded decode
step's bit-equality with the unsharded step, and the driver's
``dryrun_multichip`` entry point end to end.
"""

import jax
import numpy as np
import pytest

from dvda.parallel.mesh import AXIS_CHANNEL, AXIS_DATA, make_mesh
from dvda.parallel.step import (
    batch_shardings,
    decode_step,
    example_batch,
    make_sharded_step,
)


def test_make_mesh_uses_all_devices():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    assert mesh.axis_names == (AXIS_DATA, AXIS_CHANNEL)
    dp, tp = mesh.devices.shape
    assert dp * tp == 8 and tp == 2


def test_make_mesh_clamps_to_available_devices():
    # requesting more devices than exist is an error, never a silent
    # clamp to a smaller mesh; asking for all of them works
    with pytest.raises(ValueError, match="devices are visible"):
        make_mesh(len(jax.devices()) + 1)
    assert make_mesh(len(jax.devices())).devices.size == len(jax.devices())


def test_make_mesh_rejects_nondividing_tp():
    mesh = make_mesh(8, tp=3)  # 3 does not divide 8 → fall back
    dp, tp = mesh.devices.shape
    assert dp * tp == 8


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_step_matches_unsharded(tp):
    mesh = make_mesh(8, tp=tp)
    dp = mesh.devices.shape[0]
    batch = example_batch(F=2 * dp, C=max(8, tp), NB=2, S=16, seed=7)
    step = make_sharded_step(mesh)
    sharded = jax.device_put(batch, batch_shardings(mesh))
    out = np.asarray(step(sharded))
    ref = np.asarray(jax.jit(decode_step)(batch))
    assert out.shape == ref.shape
    assert np.array_equal(out, ref)


def test_sharded_step_production_shape():
    """One case at the real chunk geometry — 256 chains × 8 channels =
    2048 filter lanes — bit-equal sharded vs unsharded.
    Blocks are shortened (NB=4) to keep the CPU-mesh scan affordable; the
    lane count and per-block sample count match production."""
    mesh = make_mesh(8, tp=2)
    batch = example_batch(F=256, C=8, NB=4, S=40, seed=11)
    step = make_sharded_step(mesh)
    sharded = jax.device_put(batch, batch_shardings(mesh))
    out = np.asarray(step(sharded))
    ref = np.asarray(jax.jit(decode_step)(batch))
    assert out.shape == ref.shape
    assert np.array_equal(out, ref)


def test_dryrun_multichip_entry_point():
    import sys

    sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(8)

"""Engine without a CONP solver (plain MD substrate) + config validation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.md import build_engine
from lammps_user_conp2_tpu.utils.config import (ConpConfig, FFMode, MDConfig,
                                                Mode)


@pytest.mark.usefixtures("ref_decks")
def test_plain_md_no_conp():
    system, md, cfg = workloads.dilute(0)
    eng = build_engine(system, md, None)   # no charge solve: fixed charges
    st = eng.init_state()
    st2 = jax.jit(eng.step)(st)
    # charges untouched, atoms moved, energy finite
    np.testing.assert_array_equal(np.asarray(st2.q), np.asarray(st.q))
    assert float(jnp.abs(st2.x - st.x).max()) > 0
    assert np.isfinite(float(st2.energy))


@pytest.mark.usefixtures("ref_decks")
def test_config_validation():
    with pytest.raises(ValueError):
        ConpConfig(ff=FFMode.FFIELD, zneutr=True)   # mutually exclusive
    from lammps_user_conp2_tpu.models.conp import setup_conp
    system, md, cfg = workloads.dilute(0)
    with pytest.raises(ValueError):
        # cond requires ffield (reference requires the z-ramp d vector)
        setup_conp(system, md, dataclasses.replace(
            cfg, mode=Mode.COND, ff=FFMode.NORMAL))


def test_metal_units_constants():
    from lammps_user_conp2_tpu.utils.units import get_units
    u = get_units("metal")
    assert abs(u.evscale - 1.0 / 14.399645) < 1e-9
    with pytest.raises(ValueError):
        get_units("lj")

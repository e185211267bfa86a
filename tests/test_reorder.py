"""Atom-reorder invariance: electrodes_first is pure layout.

The deck workloads reorder atoms electrodes-first so per-step electrode
gathers lower as static slices (models/system.py electrodes_first).  All
physics must be invariant: run the same deck with and without the reorder
and compare thermo scalars trajectory-wise.  Agreement is to solver
tolerance, not bitwise — summation order changes.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp
from lammps_user_conp2_tpu.models.md import build_engine
from lammps_user_conp2_tpu.models.system import electrodes_first, reorder_atoms

pytestmark = pytest.mark.usefixtures("ref_decks")


def _traj(system, md, cfg, steps=25):
    solver = setup_conp(system, md, cfg)
    eng = build_engine(system, md, solver)
    st = eng.init_state()
    rows = []
    for _ in range(steps):
        st = eng.step(st)
        rows.append([float(st.scalar_out), float(st.energy)])
    return np.asarray(rows), st


def test_reorder_identity_on_contiguous():
    system, md, cfg = workloads.dilute(0)
    # deck factories already applied electrodes_first — a second call must
    # be a no-op object-wise
    assert electrodes_first(system) is system


def test_dilute_traj_invariant_under_reorder():
    system, md, cfg = workloads.dilute(0)
    # scramble the atom order with a fixed permutation, then reorder back
    # electrodes-first; trajectories must agree to f64 solver tolerance
    rng = np.random.RandomState(7)
    perm = rng.permutation(system.natoms)
    scrambled = reorder_atoms(system, perm)
    sys2 = electrodes_first(scrambled)
    assert sys2 is not scrambled  # scramble interleaves electrodes

    ref, st_ref = _traj(system, md, cfg)
    alt, st_alt = _traj(sys2, md, cfg)
    np.testing.assert_allclose(alt, ref, rtol=0, atol=1e-8)

    # per-atom charges match when mapped through tags
    qa = np.asarray(st_alt.q)[np.argsort(np.asarray(sys2.tag))]
    qr = np.asarray(st_ref.q)[np.argsort(np.asarray(system.tag))]
    np.testing.assert_allclose(qa, qr, atol=1e-10)


def test_reorder_remaps_topology():
    system, md, cfg = workloads.il_twolayer(0)
    # bonds/angles must reference the same atoms (by tag) after reorder
    rng = np.random.RandomState(3)
    perm = rng.permutation(system.natoms)
    alt = reorder_atoms(system, perm)
    ref_pairs = {tuple(sorted((int(system.tag[i]), int(system.tag[j]))))
                 for (_, i, j) in system.bonds}
    alt_pairs = {tuple(sorted((int(alt.tag[i]), int(alt.tag[j]))))
                 for (_, i, j) in alt.bonds}
    assert ref_pairs == alt_pairs
    # group masks follow their atoms
    for name in system.groups:
        ref_tags = set(system.tag[system.groups[name]])
        alt_tags = set(alt.tag[alt.groups[name]])
        assert ref_tags == alt_tags

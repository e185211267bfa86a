"""NVE energy conservation — the integrator/force-path physics oracle.

Thermostat off, fixed charges (no CONP), CPU float64: total energy
E = KE + PE must be conserved by velocity Verlet over thousands of steps.
This catches force/integrator inconsistencies (a wrong force derivative
shows up as secular drift) that trajectory-comparison tests can miss.
The charge-solve path has its own consistency oracle (test_consistency:
forces == -dE/dx through the solve); this covers the MD substrate the
reference got for free from LAMMPS (SURVEY.md section 7, hard part 1).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.md import build_engine
import pytest

pytestmark = pytest.mark.usefixtures("ref_decks")


def total_energy(eng, st):
    u = eng.system.units()
    m = np.asarray(eng.integrator.mass)
    v = np.asarray(st.v)
    ke = 0.5 * u.mvv2e * float(np.sum(m * np.sum(v * v, axis=1)))
    return ke + float(st.energy)


def test_nve_energy_conservation():
    system, md, cfg = workloads.dilute(0)
    # NVE: no thermostats; dt small enough for the stiff intramolecular
    # bonds (the deck runs SHAKE-free at dt=1 only because NVT damps the
    # bond-energy error)
    md = dataclasses.replace(md, thermostats=(), dt=0.25)
    eng = build_engine(system, md, None)   # fixed charges, no solve
    st = eng.init_state()

    # start from rest; PE<->KE exchange begins immediately and E_tot must
    # stay flat.  Sample every 100 steps over 2000; drop the first 400
    # steps (start-from-rest transient redistributes ~15 kcal/mol).
    energies = []
    for _ in range(20):
        st, _ = eng.run(st, 100, thermo_every=0)
        energies.append(total_energy(eng, st))
    e = np.asarray(energies)
    assert np.all(np.isfinite(e))
    drift = e[4:].max() - e[4:].min()
    # 432 atoms, real units.  Residual drift is the unswitched LJ/erfc
    # cutoff truncation (pairs crossing r_c see a force discontinuity —
    # same as the reference's lj/cut/coul/long under NVE); measured
    # ~5 kcal/mol per 1600 steps (2.5e-6 of |PE| = 2.0e6).  A mis-derived
    # force term (sign, factor, missing image convention) drifts orders of
    # magnitude faster — observed 1e3+ kcal/mol within hundreds of steps.
    assert drift < 25.0, f"NVE energy drift {drift:.2f} kcal/mol (post-transient)"

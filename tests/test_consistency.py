"""Global force/energy consistency: F = -dE/dx for the FULL energy surface
E(x, q*(x)) including the constant-potential charge re-solve (Hellmann-
Feynman at dV=0: q* is stationary, so the partial forces are the total
derivative).  Any error anywhere in the pair/k-space/correction/solve
pipeline shows up here."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp
from lammps_user_conp2_tpu.models.md import build_engine


@pytest.mark.usefixtures("ref_decks")
def test_forces_are_energy_gradient_through_charge_solve():
    system, md, cfg = workloads.dilute(0)
    cfg = dataclasses.replace(cfg, target=0.0)
    solver = setup_conp(system, md, cfg)
    eng = build_engine(system, md, solver)
    x0 = jnp.asarray(system.x0)
    q0 = jnp.asarray(system.q0)

    @jax.jit
    def energy_at(x):
        q, scal, rho = solver.solve_full(x, q0, 0)
        f, pe = eng.compute_forces(x, q, scal, rho)
        return pe, f

    pe0, f0 = energy_at(x0)
    rng = np.random.default_rng(1)
    h = 2e-5
    for _ in range(4):
        i = int(rng.integers(0, system.natoms))
        ax = int(rng.integers(0, 3))
        num = -(float(energy_at(x0.at[i, ax].add(h))[0])
                - float(energy_at(x0.at[i, ax].add(-h))[0])) / (2 * h)
        ana = float(f0[i, ax])
        assert abs(num - ana) / max(1.0, abs(ana)) < 1e-4, (i, ax, num, ana)


def test_forces_gradient_production_pppm_path(monkeypatch):
    """Same F = -dE/dx oracle on the PRODUCTION configuration: PPPM mesh
    k-space with the tiled z-span spread/gather, z-plane electrode
    transforms, ad force differentiation, Verlet nlist pair path, INV
    solver — every component the 100k-atom benchmark runs, engaged at test
    size by forcing the tiled branch."""
    import pytest  # noqa: F401
    from lammps_user_conp2_tpu.ops import pppm as pppm_ops
    from lammps_user_conp2_tpu.utils.config import KSpaceStyle, Solver

    monkeypatch.setattr(pppm_ops, "_use_dense", lambda grid, n: False)
    system, md, cfg = workloads.synthetic(n_elyte=1024, nele_side=6,
                                          lz=40.0, lxy=24.0)
    md = dataclasses.replace(md, pair_path="nlist",
                             kspace_style=KSpaceStyle.PPPM, pppm_diff="ad")
    cfg = dataclasses.replace(cfg, solver=Solver.INV,
                              kspace=KSpaceStyle.PPPM, target=0.0)
    solver = setup_conp(system, md, cfg)
    eng = build_engine(system, md, solver)
    st = eng.init_state()
    x0, q0, nbr, tasg = st.x, jnp.asarray(system.q0), st.nbr, st.tasg

    @jax.jit
    def energy_at(x):
        q, scal, kcache = solver.solve_full(x, q0, 0, nbr, eng.ncfg,
                                            tasg=tasg)
        f, pe = eng.compute_forces(x, q, scal, kcache, nbr, tasg)
        return pe, f

    pe0, f0 = energy_at(x0)
    assert np.isfinite(float(pe0))
    rng = np.random.default_rng(3)
    h = 2e-5
    for _ in range(4):
        i = int(rng.integers(0, system.natoms))
        ax = int(rng.integers(0, 3))
        num = -(float(energy_at(x0.at[i, ax].add(h))[0])
                - float(energy_at(x0.at[i, ax].add(-h))[0])) / (2 * h)
        ana = float(f0[i, ax])
        assert abs(num - ana) / max(1.0, abs(ana)) < 1e-4, (i, ax, num, ana)

"""Cluster-batched SHAKE/RATTLE correctness, on the synthetic rotors (the
il decks' constraint shape, no deck file)."""

import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.shake import (build_constraints,
                                                rattle_velocities_xla,
                                                shake_positions_xla)
from lammps_user_conp2_tpu.ops import shake_kernel as sk


def _rotor_constraints(m=320):
    system, scfg = workloads.rotors(m)
    return system, build_constraints(system, scfg)


def test_cluster_structure():
    system, cons = _rotor_constraints()
    # 320 cations, 3 atoms + 3 constraints each (2 bonds + 1 angle 1-3)
    assert cons.nclusters == 320
    assert cons.atoms.shape[1] == 3
    assert cons.ncons == 960
    assert bool(cons.cmask.all())
    # the angle constraint becomes the 1-3 distance (law of cosines)
    d13 = np.sqrt(2.2 ** 2 + 2.6 ** 2
                  - 2 * 2.2 * 2.6 * np.cos(np.deg2rad(110.0)))
    np.testing.assert_allclose(np.sqrt(np.asarray(cons.dist2)).max(), d13,
                               rtol=1e-12)


def test_shake_satisfies_constraints_and_conserves_com():
    system, cons = _rotor_constraints()
    rng = np.random.default_rng(0)
    x_old = jnp.asarray(system.x0)
    # perturb positions (an unconstrained drift step)
    x_new = x_old + jnp.asarray(rng.normal(scale=0.05, size=x_old.shape))
    x, dv = shake_positions_xla(cons, x_new, x_old, 2.0, box=system.box,
                                periodic=system.periodic, iters=30)
    ai = np.asarray(cons.atoms)
    xn = np.asarray(x)
    ci, cj = np.asarray(cons.ci), np.asarray(cons.cj)
    d2 = np.asarray(cons.dist2)
    box = np.asarray(system.box)
    for s in range(3):
        ri = xn[ai[np.arange(len(ai)), ci[:, s]]]
        rj = xn[ai[np.arange(len(ai)), cj[:, s]]]
        d = ri - rj
        for ax in range(3):       # minimum image (molecules straddle x/y)
            if system.periodic[ax]:
                d[:, ax] -= box[ax] * np.round(d[:, ax] / box[ax])
        err = np.abs((d ** 2).sum(1) - d2[:, s]) / d2[:, s]
        assert err.max() < 1e-6
    # COM of each cluster unchanged (constraint forces are internal)
    m = np.asarray(system.mass)
    com_before = (m[ai][:, :, None] * np.asarray(x_new)[ai]).sum(1)
    com_after = (m[ai][:, :, None] * xn[ai]).sum(1)
    np.testing.assert_allclose(com_after, com_before, atol=1e-8)
    np.testing.assert_allclose(np.asarray(dv),
                               (xn - np.asarray(x_new)) / 2.0, atol=1e-12)


def test_rattle_zeroes_bond_rates():
    system, cons = _rotor_constraints()
    rng = np.random.default_rng(1)
    x = jnp.asarray(system.x0)
    v = jnp.asarray(rng.normal(scale=0.01, size=(system.natoms, 3)))
    v2 = rattle_velocities_xla(cons, x, v, box=system.box,
                               periodic=system.periodic, iters=30)
    ai = np.asarray(cons.atoms)
    ci, cj = np.asarray(cons.ci), np.asarray(cons.cj)
    xn, vn = np.asarray(x), np.asarray(v2)
    for s in range(3):
        i = ai[np.arange(len(ai)), ci[:, s]]
        j = ai[np.arange(len(ai)), cj[:, s]]
        rij = xn[i] - xn[j]
        for ax in range(3):
            if system.periodic[ax]:
                rij[:, ax] -= system.box[ax] * np.round(rij[:, ax] / system.box[ax])
        vij = vn[i] - vn[j]
        rate = np.abs((rij * vij).sum(1))
        assert rate.max() < 1e-6


@pytest.mark.parametrize("m,dtype,rtol", [
    (320, jnp.float64, 1e-13),
    (320, jnp.float32, 2e-6),
    (1000, jnp.float32, 2e-6),
])
def test_triton_shake_matches_xla_interpret(m, dtype, rtol):
    """The Pallas-Triton SHAKE/RATTLE kernels (interpret mode on the CPU)
    reproduce the plain path: to roundoff in float64, and in float32 to
    the few-ulp drift of 12 sweeps in another operation order (the bound
    chip_smoke.py holds the card to).  M=1000 spans several programs and
    a ragged last block."""
    system, cons = _rotor_constraints(m)
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(system.x0, dtype)
    xn = x0 + jnp.asarray(rng.normal(0, 0.05, x0.shape), dtype)
    v = jnp.asarray(rng.normal(0, 0.01, x0.shape), dtype)
    box, per = system.box, system.periodic
    scale = max(box)

    x_ref, dv_ref = shake_positions_xla(cons, xn, x0, 1.0, box=box,
                                        periodic=per)
    x_k, dv_k = sk.shake_positions_triton(cons, xn, x0, 1.0, box=box,
                                          periodic=per, interpret=True)
    assert x_k.dtype == dtype
    np.testing.assert_allclose(np.asarray(x_k), np.asarray(x_ref),
                               atol=rtol * scale)
    np.testing.assert_allclose(np.asarray(dv_k), np.asarray(dv_ref),
                               atol=rtol * scale)

    v_ref = rattle_velocities_xla(cons, x_ref, v, box=box, periodic=per)
    v_k = sk.rattle_velocities_triton(cons, x_ref, v, box=box, periodic=per,
                                      interpret=True)
    np.testing.assert_allclose(np.asarray(v_k), np.asarray(v_ref),
                               atol=rtol * float(jnp.abs(v).max()))

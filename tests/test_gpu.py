"""Tests that need the card: the compiled Pallas-Triton kernel against the
plain path (interpret mode cannot show what Triton's compiler makes of
it).  They skip without a GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models import shake
from lammps_user_conp2_tpu.ops import shake_kernel as sk

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("m", [320, 10240])
def test_triton_shake_compiled_matches_xla(gpu, m):
    system, scfg = workloads.rotors(m)
    cons = shake.build_constraints(system, scfg)
    box, per = system.box, system.periodic
    rng = np.random.default_rng(m)
    with jax.default_device(gpu):
        x0 = jnp.asarray(system.x0, jnp.float32)
        xn = x0 + jnp.asarray(rng.normal(0, 0.05, x0.shape), jnp.float32)
        v = jnp.asarray(rng.normal(0, 0.01, x0.shape), jnp.float32)
        x_k, _ = jax.jit(lambda a: sk.shake_positions_triton(
            cons, a, x0, 1.0, box=box, periodic=per))(xn)
        x_r, _ = jax.jit(lambda a: shake.shake_positions_xla(
            cons, a, x0, 1.0, box=box, periodic=per))(xn)
        v_k = jax.jit(lambda b: sk.rattle_velocities_triton(
            cons, x_r, b, box=box, periodic=per))(v)
        v_r = jax.jit(lambda b: shake.rattle_velocities_xla(
            cons, x_r, b, box=box, periodic=per))(v)
    np.testing.assert_allclose(np.asarray(x_k), np.asarray(x_r),
                               atol=2e-6 * max(box))
    np.testing.assert_allclose(np.asarray(v_k), np.asarray(v_r),
                               atol=2e-6 * float(jnp.abs(v).max()))

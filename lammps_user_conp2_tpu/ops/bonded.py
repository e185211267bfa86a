"""Harmonic bond and angle forces (LAMMPS bond_style/angle_style harmonic).

E_bond = K (r - r0)^2 ; E_angle = K (theta - theta0)^2  (no 1/2 factors,
LAMMPS convention).  Static topology arrays -> fixed-shape segment_sum
scatters; per-molecule bonds never cross the minimum image at test scales
but we min-image anyway for robustness.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from .pairs import min_image


def bonded_forces(x, bonds, bond_coeffs, angles, angle_coeffs, *, box,
                  periodic):
    """Bond + angle forces with ONE combined scatter-add.

    Instead of five separate .at[].add calls (2 bond + 3 angle), all
    (row, contribution) pairs are built first and scattered in one pass.
    Returns (f, e_bond+e_angle).
    """
    nb = bonds.shape[0]
    na = angles.shape[0]
    if nb == 0 and na == 0:
        return jnp.zeros_like(x), jnp.zeros((), x.dtype)
    boxj = jnp.asarray(box, x.dtype)
    rows = []
    vals = []
    e = jnp.zeros((), x.dtype)
    if nb:
        bt, i, j = bonds[:, 0], bonds[:, 1], bonds[:, 2]
        k = bond_coeffs[bt, 0]
        r0 = bond_coeffs[bt, 1]
        dx = min_image(x[i] - x[j], boxj, periodic)
        r = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
        dr = r - r0
        e = e + jnp.sum(k * dr * dr)
        fij = jnp.where(r > 0, -2.0 * k * dr / r, 0.0)[:, None] * dx
        rows += [i, j]
        vals += [fij, -fij]
    if na:
        at = angles[:, 0]
        i, j, k = angles[:, 1], angles[:, 2], angles[:, 3]
        ka = angle_coeffs[at, 0]
        t0 = angle_coeffs[at, 1] * (math.pi / 180.0)
        d1 = min_image(x[i] - x[j], boxj, periodic)
        d2 = min_image(x[k] - x[j], boxj, periodic)
        r1sq = jnp.sum(d1 * d1, axis=-1)
        r2sq = jnp.sum(d2 * d2, axis=-1)
        r1 = jnp.sqrt(r1sq)
        r2 = jnp.sqrt(r2sq)
        c = jnp.clip(jnp.sum(d1 * d2, axis=-1) / (r1 * r2), -1.0, 1.0)
        s = jnp.maximum(jnp.sqrt(jnp.maximum(1.0 - c * c, 0.0)), 0.001)
        dtheta = jnp.arccos(c) - t0
        e = e + jnp.sum(ka * dtheta * dtheta)
        a = -2.0 * ka * dtheta / s
        a11 = a * c / r1sq
        a12 = -a / (r1 * r2)
        a22 = a * c / r2sq
        f1 = a11[:, None] * d1 + a12[:, None] * d2
        f3 = a22[:, None] * d2 + a12[:, None] * d1
        rows += [i, k, j]
        vals += [f1, f3, -(f1 + f3)]
    f = jnp.zeros_like(x).at[jnp.concatenate(rows)].add(
        jnp.concatenate(vals, axis=0))
    return f, e

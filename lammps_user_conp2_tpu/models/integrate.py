"""Velocity-Verlet integration with group Nose-Hoover chain thermostats.

The reference delegates integration to LAMMPS (SURVEY.md section 0); this is
the substrate here: pure functions over fixed-shape arrays, suitable
for lax.scan.  Semantics follow LAMMPS fix nvt (Nose-Hoover chains, default
tchain=3, MTK-less group thermostatting as used by the test decks
`fix 1 sol nvt temp T T 100`): at each step

    nhc half-kick -> velocity half-kick -> drift -> [forces] ->
    velocity half-kick -> nhc half-kick

Atoms outside every integrator group are frozen (the electrodes in all
reference decks: velocities zeroed, no integration fix).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.units import Units


class NHCParams(NamedTuple):
    """Static per-thermostat parameters."""
    group_mask: jnp.ndarray    # (N,) bool
    dof: jnp.ndarray           # () float — 3*Ng - 3 - nconstraints
    t_start: jnp.ndarray
    t_stop: jnp.ndarray
    damp: jnp.ndarray          # fs
    tchain: int


def group_ke(v, mass, mask, mvv2e):
    """2x kinetic energy (sum m v^2 * mvv2e) of a group."""
    mv2 = jnp.sum(mass[:, None] * v * v, axis=1)
    return mvv2e * jnp.sum(jnp.where(mask, mv2, 0.0))


def group_temperature(v, mass, mask, dof, units: Units):
    return group_ke(v, mass, mask, units.mvv2e) / (dof * units.boltz)


def nhc_half_step(v, xi, vxi, params: NHCParams, mass, dt, boltz, mvv2e, t_target):
    """Half-step Nose-Hoover chain update; returns (v_scaled, xi, vxi).

    Standard Martyna-Tuckerman-Klein chain (tchain links, 1 Suzuki-Yoshida
    loop like LAMMPS default tloop=1)."""
    m = params.tchain
    dof = params.dof
    kt = boltz * t_target
    # thermostat masses: Q1 = dof kT damp^2, Qk = kT damp^2.  dtype follows
    # the chain state: default-f64 scalars here would silently promote g and
    # hit the f32 vxi scatters (an error in a future jax)
    q = jnp.concatenate([
        jnp.array([dof * kt * params.damp ** 2]),
        jnp.full((m - 1,), kt * params.damp ** 2),
    ]).astype(vxi.dtype)
    ke2 = group_ke(v, mass, params.group_mask, mvv2e)  # sum m v^2

    dt2 = dt / 2.0
    dt4 = dt / 4.0
    dt8 = dt / 8.0

    # update chain velocities from the end inward
    g = jnp.zeros(m, vxi.dtype)
    g = g.at[0].set((ke2 - dof * kt) / q[0])
    for k in range(1, m):
        g = g.at[k].set((q[k - 1] * vxi[k - 1] ** 2 - kt) / q[k])

    vxi = vxi.at[m - 1].add(g[m - 1] * dt4)
    for k in range(m - 2, -1, -1):
        ef = jnp.exp(-dt8 * vxi[k + 1])
        vxi = vxi.at[k].set((vxi[k] * ef + g[k] * dt4) * ef)

    # scale particle velocities
    scale = jnp.exp(-dt2 * vxi[0])
    v = jnp.where(params.group_mask[:, None], v * scale, v)
    ke2 = ke2 * scale * scale
    xi = xi + dt2 * vxi

    # second pass outward
    g = g.at[0].set((ke2 - dof * kt) / q[0])
    for k in range(0, m - 1):
        ef = jnp.exp(-dt8 * vxi[k + 1])
        vxi = vxi.at[k].set((vxi[k] * ef + g[k] * dt4) * ef)
        g = g.at[k + 1].set((q[k] * vxi[k] ** 2 - kt) / q[k + 1])
    vxi = vxi.at[m - 1].add(g[m - 1] * dt4)
    return v, xi, vxi


@dataclasses.dataclass(frozen=True)
class Integrator:
    """Velocity Verlet with per-group NHC thermostats and frozen non-mobile atoms."""
    dt: float
    units: Units
    mass: jnp.ndarray           # (N,)
    mobile_mask: jnp.ndarray    # (N,) bool — atoms that move at all
    thermostats: tuple          # tuple[NHCParams]

    def t_target(self, params: NHCParams, step):
        # linear ramp t_start -> t_stop is deck-dependent; decks use constant
        return params.t_start

    def thermostat_half(self, v, xi, vxi, step):
        new_xi, new_vxi = [], []
        for i, p in enumerate(self.thermostats):
            v, xi_i, vxi_i = nhc_half_step(
                v, xi[i], vxi[i], p, self.mass, self.dt,
                self.units.boltz, self.units.mvv2e, self.t_target(p, step))
            new_xi.append(xi_i)
            new_vxi.append(vxi_i)
        if self.thermostats:
            xi = jnp.stack(new_xi)
            vxi = jnp.stack(new_vxi)
        return v, xi, vxi

    def kick(self, v, f):
        dtfm = (self.dt / 2.0) * self.units.ftm2v / self.mass[:, None]
        vnew = v + dtfm * f
        return jnp.where(self.mobile_mask[:, None], vnew, v)

    def drift(self, x, v):
        xnew = x + self.dt * v
        return jnp.where(self.mobile_mask[:, None], xnew, x)


def make_nhc_params(group_mask: np.ndarray, t_start, t_stop, damp,
                    *, nconstraints: int = 0, tchain: int = 3,
                    extra_dof: int = 3) -> NHCParams:
    ng = int(group_mask.sum())
    dof = 3 * ng - extra_dof - nconstraints
    return NHCParams(
        group_mask=jnp.asarray(group_mask),
        dof=jnp.asarray(float(dof)),
        t_start=jnp.asarray(float(t_start)),
        t_stop=jnp.asarray(float(t_stop)),
        damp=jnp.asarray(float(damp)),
        tchain=tchain,
    )

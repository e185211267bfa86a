"""Diagnostic computes: potential/atom and the nghosts analogue.

potential/atom (reference: compute_potential_atom.cpp) — per-atom electric
potential in volts: real-space erfc sums with optional Gaussian-electrode
corrections, k-space mesh readout (or classic-Ewald equivalent), slab
correction, all scaled by evscale (compute_potential_atom.cpp:181).

nghosts (reference: compute_nghosts.cpp) counts LAMMPS ghost copies per
atom; this analogue counts the periodic images a 1-rank LAMMPS would
ghost — pure geometry, useful to sanity-check cutoff/box interplay.
"""

from __future__ import annotations

import math
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..ops import ewald as ewald_ops
from ..ops.erfc import ERFC_MAX, erfc_as
from ..ops.pairs import min_image

MY_PIS = math.sqrt(math.pi)


def potential_atom(
    x, q, *,
    group_mask,              # (N,) bool — atoms to evaluate (others -> 0)
    elecheck,                # (N,) int +-1/0 for the eta correction
    box, periodic, cutoff, g_ewald, evscale, volume,
    eta: float = 0.0,
    pairflag: bool = True,
    kspaceflag: bool = True,
    slabflag: bool = False,
    qsumflag: bool = True,
    pppm_grid=None,          # PPPMGrid -> mesh readout; None -> classic Ewald
    kvecs=None, ug=None,     # required when pppm_grid is None and kspaceflag
):
    """Returns per-atom potential (N,) in volts."""
    n = x.shape[0]
    pot = jnp.zeros(n, x.dtype)
    is_ele = elecheck != 0

    if pairflag:
        cutsq = min(cutoff ** 2, (ERFC_MAX / g_ewald) ** 2)
        dx = min_image(x[:, None, :] - x[None, :, :], jnp.asarray(box, x.dtype),
                       periodic)
        rsq = jnp.sum(dx * dx, axis=-1)
        rsq = jnp.maximum(rsq, 1e-10)
        mask = (rsq < cutsq) & (~jnp.eye(n, dtype=bool))
        # pair counted when either atom is in the group (cpa.cpp:263-265);
        # computing rows only for group atoms gives the identical result
        r = jnp.sqrt(rsq)
        dudq = erfc_as(g_ewald * r) / r
        if eta != 0.0:
            nele = is_ele[:, None].astype(jnp.int32) + is_ele[None, :].astype(jnp.int32)
            etarij = jnp.where(nele == 2, eta / math.sqrt(2.0), eta) * r
            corr = jnp.where((nele > 0) & (etarij < ERFC_MAX),
                             erfc_as(etarij) / r, 0.0)
            dudq = dudq - corr
        pot = pot + jnp.sum(jnp.where(mask, dudq, 0.0) * q[None, :], axis=1)

    if kspaceflag:
        if pppm_grid is not None:
            from ..ops import pppm as pppm_ops
            rho = pppm_ops.spread(pppm_grid, x, q)
            u = pppm_ops.poisson_u(pppm_grid, rho)
            phik = pppm_ops.gather(pppm_grid, u, x)
        else:
            sre, sim = ewald_ops.structure_factor(x, q, kvecs)
            phik = ewald_ops.kspace_potential_on_points(x, kvecs, ug, sre, sim)
        # mesh/Ewald potential minus the Gaussian self term
        # (pppm_conp.cpp:452-488: u includes +2g/sqrt(pi) q; cpa subtracts it)
        pot = pot + phik - 2.0 * g_ewald / MY_PIS * q
        if eta != 0.0:
            pot = pot + jnp.where(is_ele, eta * q * math.sqrt(2.0) / MY_PIS, 0.0)
        if slabflag:
            slabcorr = (4.0 * math.pi / volume) * jnp.sum(q * x[:, 2])
            pot = pot + x[:, 2] * slabcorr
            if qsumflag:
                qsum = jnp.sum(q)
                pot = pot - (2.0 * math.pi / volume) * qsum * x[:, 2] ** 2

    pot = jnp.where(jnp.asarray(group_mask), pot, 0.0)
    # internal (e/A) -> volts: the compute's own scale is qqr2e/qe2f, the
    # INVERSE of the fix's evscale (compute_potential_atom.cpp:109 vs
    # fix_conp.cpp:412)
    return pot / evscale


def nghosts(x, *, box, box_lo, cutoff, periodic):
    """Ghost-image count per atom for a single spatial domain (the 1-rank
    LAMMPS value of compute nghosts, compute_nghosts.cpp:36-58)."""
    x = np.asarray(x)
    count = np.ones(len(x), np.int64)
    for ax in range(3):
        if not periodic[ax]:
            continue
        lo = box_lo[ax]
        hi = box_lo[ax] + box[ax]
        near = ((x[:, ax] - lo) < cutoff).astype(np.int64) + \
               ((hi - x[:, ax]) < cutoff).astype(np.int64)
        count *= 1 + near
    return count - 1


def group_potential(x, q, group_mask, **kw):
    """Average potential of a group in volts — compute_group_potential
    equivalent (pppm_conp.cpp:490-534; consumed per-electrode by users)."""
    pot = potential_atom(x, q, group_mask=group_mask, **kw)
    g = jnp.asarray(group_mask)
    return jnp.sum(jnp.where(g, pot, 0.0)) / jnp.sum(g)

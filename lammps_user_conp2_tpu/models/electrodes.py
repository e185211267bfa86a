"""Electrode bookkeeping, A-matrix assembly, inversion + projection, d-vector.

This is the re-expression of FixConp's linear-algebra setup
(reference: fix_conp.cpp:426-464 linalg_setup; 777-861 a_cal; 932-980 inv;
982-1067 inv_project; 609-637 b_setq_cal; 1071-1116 get_setq).

Key simplifications enabled by the architecture:
  * electrode membership is static -> all index maps are fixed host arrays;
  * the A matrix k-space block is two matmuls (no parity checkerboard,
    no MPI mirror: the dense ordered-pair computation IS the symmetrized
    matrix);
  * the inverse + electroneutrality projection run once on device in f64.

The physics is g_ewald-independent once converged, which our tests exploit
as an oracle (charges must be invariant under g perturbations).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import jax.numpy as jnp
import numpy as np

from ..ops import ewald as ewald_ops
from ..ops.erfc import ERFC_MAX, erfcr_sqrt
from ..ops.pairs import (build_ehgo_tables, ehgo_pair_kernels, eta_pair_kernels,
                         min_image)
from ..utils.config import ConpConfig, FFMode, PairMode
from .system import System

MY_PIS = math.sqrt(math.pi)


class ConpContext(NamedTuple):
    """Device-resident static context for the per-step charge solve."""
    ainv: jnp.ndarray        # (Ne, Ne) projected inverse (INV solver)
    amat: jnp.ndarray        # (Ne, Ne) raw A (CG solver; (1,1) zeros otherwise)
    real_block: jnp.ndarray  # (Ne, Ne) real-space A block (CG_MATFREE; else (1,1))
    diag_extra: jnp.ndarray  # (Ne,) non-kspace diagonal (CG_MATFREE; else (1,))
    d: jnp.ndarray           # (Ne,) applied-potential coupling vector
    elesetq: jnp.ndarray     # (Ne,) A^-1 d
    totsetq: jnp.ndarray     # () sum over left electrode of elesetq
    eleinitq: jnp.ndarray    # (Ne,) initial charges baseline (qinit) or zeros
    elecheck_ele: jnp.ndarray  # (Ne,) +1/-1
    ele_idx: jnp.ndarray     # (Ne,) indices into the global atom arrays
    # cond-mode feedback
    setzvec: jnp.ndarray     # (Ne,)
    vmult: jnp.ndarray       # ()


@dataclasses.dataclass(frozen=True)
class ElectrodeKernels:
    """Pair-mode polymorphism (fix_conp.h:91-94 member-function pointers)."""
    potential: Callable    # blist / b-vector kernel
    force: Callable        # post-force correction kernel
    potential_A: Callable  # A-matrix variant (eta/sqrt(2) in ETA mode)
    self_diag: np.ndarray  # (N,) per-atom A diagonal self term


def make_kernels(cfg: ConpConfig, system: System) -> ElectrodeKernels:
    n = system.natoms
    if cfg.pairmode is PairMode.ETA:
        pot, frc, pot_a = eta_pair_kernels(cfg.eta)
        # diagonal self term sqrt(2/pi)*eta (fix_conp.cpp:796-801)
        self_diag = np.full(n, math.sqrt(2.0) / MY_PIS * cfg.eta)
        return ElectrodeKernels(pot, frc, pot_a, self_diag)
    # EHGO (fix_conp.cpp:803-810 diagonal u0_i)
    eh = cfg.ehgo
    evscale = system.units().evscale
    eta_i, u0_i, eta_ij, fo_ij = build_ehgo_tables(
        system.ntypes, eh.kappa, eh.eta_by_type, evscale)
    pot, frc, pot_a = ehgo_pair_kernels(
        jnp.asarray(eta_ij), jnp.asarray(fo_ij), jnp.asarray(u0_i))
    self_diag = u0_i[system.type]
    return ElectrodeKernels(pot, frc, pot_a, self_diag)


def assemble_amatrix(
    xe, type_e, self_diag_e, ksp: ewald_ops.EwaldKSpace, kernels: ElectrodeKernels,
    *, box, periodic, cut_coulsq: float, dtype=jnp.float64,
):
    """Full A matrix: k-space block + real-space erfc + Gaussian self terms.

    Real-space off-diagonal (alist_coul_cal, fix_conp.cpp:1209-1279):
      dudq = erfc(g r)/r + pair_potential_A(r^2)
    gated by rsq < min(coul cutoff^2, ERFC_MAX^2/g^2).
    """
    g = ksp.g_ewald
    cutsq = min(cut_coulsq, (ERFC_MAX / g) ** 2)
    # Above ~1e10 flops (Ne^2 K) the device path's (Ne, K) trig tables are
    # tens of GB and the f64 matmuls take minutes on the CPU XLA backend —
    # assemble on the host via the plane-factored numpy path instead
    # (setup always runs with concrete positions; tracers keep the jnp path).
    xe_np = None
    if xe.shape[0] ** 2 * ksp.kcount > 1e10:
        try:
            xe_np = np.asarray(xe)
        except Exception:  # traced xe (mobile-electrode rebuild) — jnp path
            xe_np = None
    if xe_np is not None:
        from ..ops.ewald_factored import amatrix_kspace_host
        a = jnp.asarray(amatrix_kspace_host(xe_np, ksp), dtype)
    else:
        a = ewald_ops.amatrix_kspace(xe, ksp, dtype=dtype)
    ne = xe.shape[0]
    dx = min_image(xe[:, None, :] - xe[None, :, :], jnp.asarray(box, dtype), periodic)
    rsq = jnp.sum(dx * dx, axis=-1)
    eye = jnp.eye(ne, dtype=bool)
    mask = (rsq < cutsq) & (~eye)
    rsq_safe = jnp.where(mask, rsq, 1.0)
    dudq = erfcr_sqrt(g * g * rsq_safe) * g + kernels.potential_A(
        rsq_safe, type_e[:, None], type_e[None, :])
    a = a + jnp.where(mask, dudq, 0.0)
    a = a + jnp.diag(jnp.asarray(self_diag_e, dtype))
    return a


def project_inverse(ainv, *, nullneutral: bool, zneutr: bool, z_e=None, zhalf=None):
    """Electroneutrality projection of A^-1 (inv_project, fix_conp.cpp:982-1067).

    ainv <- ainv - (ainv e)(ainv e)^T / (e^T ainv e), then optionally the same
    against e_pos (indicator z > zhalf).  Returns (ainv, ee_log) where
    ee_log = e^T A^-1 e (the `<e,e>` diagnostic, fix_conp.cpp:1006-1009).
    """
    ainve = jnp.sum(ainv, axis=1)
    totinve = jnp.sum(ainve)
    if nullneutral:
        ainv = jnp.where(
            totinve * totinve > 1e-8,
            ainv - jnp.outer(ainve, ainve) / totinve,
            ainv,
        )
        if zneutr:
            pos = (z_e > zhalf).astype(ainv.dtype)
            ainve2 = ainv @ pos
            totinve2 = jnp.sum(ainve2 * pos)
            ainv = jnp.where(
                totinve2 * totinve2 > 1e-8,
                ainv - jnp.outer(ainve2, ainve2) / totinve2,
                ainv,
            )
    return ainv, totinve


def build_d_vector(system: System, cfg: ConpConfig, xe) -> np.ndarray:
    """b_setq_cal (fix_conp.cpp:609-637): the applied-potential coupling.

    NORMAL/NOSLAB: d_i = -0.5*evscale*(+-1).
    FFIELD: z-ramp d_i = -evscale*(z/Lz [+1 if left electrode in lower half]).
    """
    evscale = system.units().evscale
    eci = system.elecheck[system.ele_mask]
    xe = np.asarray(xe)
    if cfg.ff is FFMode.FFIELD:
        zlo = system.box_lo[2]
        zprd = system.box[2]
        zhalf = zlo + zprd / 2
        z = xe[:, 2]
        d = -evscale * z / zprd
        d = np.where((eci == 1) & (z < zhalf), -evscale * (z / zprd + 1.0), d)
    else:
        d = -0.5 * evscale * eci
    return d

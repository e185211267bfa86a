"""SHAKE / RATTLE holonomic constraints (LAMMPS fix shake semantics).

The il decks constrain the 3-site BMI cation (bond types 1,2 + the 180-degree
angle, tests/il_onelayer/input: ``fix bmishake bmi shake 0.0001 10 0 t 1 2 3
b 1 2 a 1``), making each cation a rigid linear rotor.  Angle constraints
become 1-3 distances via the law of cosines (LAMMPS shake3angle equivalent).

Constraints are grouped into their disjoint CLUSTERS (<=4 atoms, <=3
constraints — the LAMMPS shake cluster shapes) at setup.  Each step
gathers every cluster's atoms ONCE into an (M, K, 3) batch, iterates
Gauss-Seidel over the constraint slots (one-hot column updates — no
scatters inside the loop), and writes back once.  On a GPU the whole
iteration runs as one Pallas-Triton kernel (ops/shake_kernel.py); the
plain path below is its reference and runs everywhere else.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.pairs import min_image


@dataclasses.dataclass(frozen=True)
class ShakeConstraints:
    """Static cluster-batched constraint tables.

    atoms: (M, K) global atom indices (padded with atoms[...,0]);
    amask:  (M, K) bool valid;
    ci, cj: (M, C) local column indices of each constraint's pair;
    dist2:  (M, C) target squared distances (0 rows padded);
    cmask:  (M, C) bool;
    invm:   (M, K) inverse masses (0 for padding).
    """
    atoms: jnp.ndarray
    amask: jnp.ndarray
    ci: jnp.ndarray
    cj: jnp.ndarray
    dist2: jnp.ndarray
    cmask: jnp.ndarray
    invm: jnp.ndarray
    pair_atoms: np.ndarray   # host (ncons, 2) — constrained atom pairs
    ncons: int

    def n_in_group(self, gmask) -> int:
        """Constraints removed from a thermostatted group's DOF count: a
        constraint is attributed to the group when BOTH its atoms are in it
        (a pair straddling the boundary doesn't remove an internal DOF)."""
        p = self.pair_atoms
        return int((gmask[p[:, 0]] & gmask[p[:, 1]]).sum())

    @property
    def nclusters(self) -> int:
        return self.atoms.shape[0]


def build_constraints(system, shake_cfg) -> ShakeConstraints | None:
    """From topology + ShakeConfig (bond types, angle types, group mask)."""
    if shake_cfg is None:
        return None
    gmask = system.groups[shake_cfg.group]
    pairs = []
    d0 = []
    bond_r0 = {int(t): system.bond_coeffs[t, 1] for t in range(len(system.bond_coeffs))}
    bonded = {}
    for (t, i, j) in system.bonds:
        if int(t) in shake_cfg.btypes and gmask[i] and gmask[j]:
            pairs.append((int(i), int(j)))
            d0.append(bond_r0[int(t)])
        bonded[(int(i), int(j))] = bond_r0[int(t)]
        bonded[(int(j), int(i))] = bond_r0[int(t)]
    for (t, i, j, k) in system.angles:
        if int(t) in shake_cfg.atypes and gmask[i] and gmask[j] and gmask[k]:
            r1 = bonded[(int(i), int(j))]
            r2 = bonded[(int(j), int(k))]
            th = system.angle_coeffs[int(t), 1] * math.pi / 180.0
            d13 = math.sqrt(r1 * r1 + r2 * r2 - 2 * r1 * r2 * math.cos(th))
            pairs.append((int(i), int(k)))
            d0.append(d13)
    if not pairs:
        return None

    # connected components -> clusters
    parent = {}

    def find(a):
        while parent.get(a, a) != a:
            parent[a] = parent.get(parent[a], parent[a])
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for (i, j) in pairs:
        parent.setdefault(i, i)
        parent.setdefault(j, j)
        union(i, j)
    clusters = {}
    for (idx, (i, j)) in enumerate(pairs):
        clusters.setdefault(find(i), []).append(idx)

    K = max(len({a for c in cons for a in pairs[c]}) for cons in clusters.values())
    C = max(len(cons) for cons in clusters.values())
    if K > 4 or C > 6:
        raise ValueError(f"shake cluster too large (K={K}, C={C}); LAMMPS "
                         "supports <=4 atoms per cluster")
    M = len(clusters)
    atoms = np.zeros((M, K), np.int64)
    amask = np.zeros((M, K), bool)
    ci = np.zeros((M, C), np.int64)
    cj = np.zeros((M, C), np.int64)
    dist2 = np.ones((M, C))
    cmask = np.zeros((M, C), bool)
    for m, cons in enumerate(clusters.values()):
        local = []
        for c in cons:
            for a in pairs[c]:
                if a not in local:
                    local.append(a)
        atoms[m, :len(local)] = local
        atoms[m, len(local):] = local[0]        # pad with first atom (masked)
        amask[m, :len(local)] = True
        for s, c in enumerate(cons):
            i, j = pairs[c]
            ci[m, s] = local.index(i)
            cj[m, s] = local.index(j)
            dist2[m, s] = d0[c] ** 2
            cmask[m, s] = True

    invm = np.where(amask, 1.0 / system.mass[atoms], 0.0)
    return ShakeConstraints(
        atoms=jnp.asarray(atoms), amask=jnp.asarray(amask),
        ci=jnp.asarray(ci), cj=jnp.asarray(cj),
        dist2=jnp.asarray(dist2), cmask=jnp.asarray(cmask),
        invm=jnp.asarray(invm),
        pair_atoms=np.asarray(pairs, np.int64), ncons=len(pairs),
    )


def _onehot_cols(idx, K, dtype):
    # (M, C) -> (M, C, K) one-hot over the cluster-local column axis
    return (idx[..., None] == jnp.arange(K)[None, None, :]).astype(dtype)


def _on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def shake_positions(cons: ShakeConstraints, x_new, x_old, dt, *, box, periodic,
                    iters: int = 12, omega: float = 1.0):
    """Correct x_new so constraints hold; returns (x, dv = (xc-x_new)/dt).

    Classic SHAKE with reference geometry from pre-drift positions; iterated
    Gauss-Seidel over the cluster's constraint slots.
    """
    if _on_gpu():
        from ..ops.shake_kernel import shake_positions_triton
        return shake_positions_triton(cons, x_new, x_old, dt, box=box,
                                      periodic=periodic, iters=iters,
                                      omega=omega)
    return shake_positions_xla(cons, x_new, x_old, dt, box=box,
                               periodic=periodic, iters=iters, omega=omega)


def shake_positions_xla(cons: ShakeConstraints, x_new, x_old, dt, *, box,
                        periodic, iters: int = 12, omega: float = 1.0):
    """The plain-JAX SHAKE iteration (reference for the kernel)."""
    M, K = cons.atoms.shape
    C = cons.ci.shape[1]
    dtype = x_new.dtype
    boxj = jnp.asarray(box, dtype)
    xc = x_new[cons.atoms]                       # (M, K, 3)
    xo = x_old[cons.atoms]
    ohi = _onehot_cols(cons.ci, K, dtype)        # (M, C, K)
    ohj = _onehot_cols(cons.cj, K, dtype)

    def take(arr, idx):
        # arr (M,K,3), idx (M,) -> (M,3)
        return jnp.take_along_axis(arr, idx[:, None, None].repeat(3, -1), axis=1)[:, 0]

    invm = cons.invm.astype(dtype)
    dist2 = cons.dist2.astype(dtype)
    invmi = jnp.take_along_axis(invm, cons.ci, axis=1)  # (M, C)
    invmj = jnp.take_along_axis(invm, cons.cj, axis=1)
    invm_sum = invmi + invmj

    # reference bond vectors (pre-drift), per constraint slot
    r_old = []
    for s in range(C):
        r_old.append(min_image(take(xo, cons.ci[:, s]) - take(xo, cons.cj[:, s]),
                               boxj, periodic))

    def body(_, xc):
        for s in range(C):
            rn = min_image(take(xc, cons.ci[:, s]) - take(xc, cons.cj[:, s]),
                           boxj, periodic)
            diff = jnp.sum(rn * rn, axis=1) - dist2[:, s]
            denom = 2.0 * invm_sum[:, s] * jnp.sum(rn * r_old[s], axis=1)
            lam = omega * diff / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)
            lam = jnp.where(cons.cmask[:, s], lam, 0.0)
            corr = lam[:, None] * r_old[s]                       # (M,3)
            xc = xc - (ohi[:, s, :, None] * (invmi[:, s, None] * corr)[:, None, :])
            xc = xc + (ohj[:, s, :, None] * (invmj[:, s, None] * corr)[:, None, :])
        return xc

    xc = jax.lax.fori_loop(0, iters, body, xc)
    # single write-back (pad columns carry duplicates of column 0 — masked)
    flat_idx = jnp.where(cons.amask, cons.atoms, x_new.shape[0])
    x = x_new.at[flat_idx.reshape(-1)].set(
        xc.reshape(-1, 3), mode="drop")
    dv = (x - x_new) / dt
    return x, dv


def rattle_velocities(cons: ShakeConstraints, x, v, *, box, periodic,
                      iters: int = 12, omega: float = 1.0):
    """Project velocities onto the constraint manifold (sum v_ij . r_ij = 0)."""
    if _on_gpu():
        from ..ops.shake_kernel import rattle_velocities_triton
        return rattle_velocities_triton(cons, x, v, box=box,
                                        periodic=periodic, iters=iters,
                                        omega=omega)
    return rattle_velocities_xla(cons, x, v, box=box, periodic=periodic,
                                 iters=iters, omega=omega)


def rattle_velocities_xla(cons: ShakeConstraints, x, v, *, box, periodic,
                          iters: int = 12, omega: float = 1.0):
    """The plain-JAX RATTLE iteration (reference for the kernel)."""
    M, K = cons.atoms.shape
    C = cons.ci.shape[1]
    dtype = x.dtype
    boxj = jnp.asarray(box, dtype)
    xc = x[cons.atoms]
    vc = v[cons.atoms]
    ohi = _onehot_cols(cons.ci, K, dtype)
    ohj = _onehot_cols(cons.cj, K, dtype)

    def take(arr, idx):
        return jnp.take_along_axis(arr, idx[:, None, None].repeat(3, -1), axis=1)[:, 0]

    invm = cons.invm.astype(dtype)
    invmi = jnp.take_along_axis(invm, cons.ci, axis=1)
    invmj = jnp.take_along_axis(invm, cons.cj, axis=1)
    invm_sum = invmi + invmj
    r = []
    denom = []
    for s in range(C):
        rs = min_image(take(xc, cons.ci[:, s]) - take(xc, cons.cj[:, s]),
                       boxj, periodic)
        r.append(rs)
        denom.append(invm_sum[:, s] * jnp.sum(rs * rs, axis=1))

    def body(_, vc):
        for s in range(C):
            vij = take(vc, cons.ci[:, s]) - take(vc, cons.cj[:, s])
            mu = omega * jnp.sum(vij * r[s], axis=1) / jnp.where(
                denom[s] > 1e-12, denom[s], 1e-12)
            mu = jnp.where(cons.cmask[:, s], mu, 0.0)
            corr = mu[:, None] * r[s]
            vc = vc - (ohi[:, s, :, None] * (invmi[:, s, None] * corr)[:, None, :])
            vc = vc + (ohj[:, s, :, None] * (invmj[:, s, None] * corr)[:, None, :])
        return vc

    vc = jax.lax.fori_loop(0, iters, body, vc)
    flat_idx = jnp.where(cons.amask, cons.atoms, x.shape[0])
    return v.at[flat_idx.reshape(-1)].set(vc.reshape(-1, 3), mode="drop")

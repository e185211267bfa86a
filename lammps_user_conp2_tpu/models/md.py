"""The MD engine: jit-compiled velocity-Verlet loop with the charge solve fused in.

This replaces the LAMMPS host runtime (SURVEY.md L0) for the workloads the
reference targets.  Structure: a pure step function over an MDState
pytree, composed into lax.scan; the charge solve (ConpSolver.solve) runs in
pre-force position exactly like FixConp::pre_force (fix_conp.cpp:543-573),
the Gaussian correction + efield coupling in post-force position
(fix_conp.cpp:577-580, 1163-1201).

Step order (LAMMPS Verlet::run):
  NHC half -> kick half -> drift (-> SHAKE) -> charge solve (every Nevery)
  -> forces -> post-force corrections -> kick half (-> RATTLE) -> NHC half
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import ewald as ewald_ops
from ..ops.bonded import bonded_forces
from ..ops.pairs import (conp_correction_forces, dense_pair_forces,
                         make_pair_tables)
from ..utils.config import MDConfig, PairMode
from .conp import ConpSolver
from .electrodes import MY_PIS
from .integrate import Integrator, group_temperature, make_nhc_params
from .shake import (ShakeConstraints, build_constraints, rattle_velocities,
                    shake_positions)
from .system import MDState, System, exclusion_lists


@dataclasses.dataclass(frozen=True)
class Engine:
    system: System
    md: MDConfig
    conp: Optional[ConpSolver]
    integrator: Integrator
    cons: Optional[ShakeConstraints]
    ksp_force: ewald_ops.EwaldKSpace
    pppm_grid: object            # PPPMGrid or None — mesh force path
    zmirror: object              # ZMirror or None — mirror-symmetry fix
    fksp: object                 # FactoredKSpace or None — matmul Ewald fast path
    cell_grid: object            # CellGrid or None — large-N pair path
    ncfg: object                 # NeighborConfig or None — Verlet-list path
    # device constants
    type_idx: jnp.ndarray
    exclusions: tuple            # (excl_idx, excl_val) — sparse special bonds
    tables: object
    elecheck: jnp.ndarray
    dtype: object
    # persistent mesh-tile binning (ops/pppm.py TileAssign carried in
    # MDState.tasg, rebuilt on the Verlet skin trigger): True only when the
    # tiled PPPM path is active, a Verlet list provides the rebuild trigger,
    # and the skin bound keeps drift within the tile margin
    mesh_persist: bool = False
    # jitted-scan cache keyed by (nsteps,) so repeated run() calls don't
    # retrace (frozen dataclass: the dict itself is mutable)
    _run_cache: dict = dataclasses.field(default_factory=dict, compare=False)

    # ------------------------------------------------------------- forces
    def compute_forces(self, x, q, scalar_out, kcache=None, nbr=None,
                       tasg=None):
        """Returns (f, pe) for the current configuration.

        In PPPM mode ``kcache`` is (rhok_elyte, tile_slots) cached by the
        charge solve — the reuse invariant of pppm/conp (SURVEY.md 3.4;
        pppm_conp.cpp:428-450): exactly one electrolyte spread AND one tile
        binning per step serve both the charge solve and the force
        evaluation.  ``nbr`` is the current NeighborList when the
        Verlet-list path is active; ``tasg`` the persistent mesh-tile
        assignment (mesh_persist) when no kcache slots are available."""
        sys = self.system
        u = sys.units()
        box = self.ksp_force.box
        # factored-Ewald per-step cache from the solve: (tabs, Sr_elyte,
        # Si_elyte), valid only when built in this dtype (a mixed-precision
        # solve caches its own dtype)
        ew_cache = None
        if (kcache is not None and self.conp is not None
                and self.pppm_grid is None and self.fksp is not None
                and kcache[0][0][0].dtype == x.dtype):
            ew_cache = kcache
        if self.ncfg is not None and nbr is not None:
            from ..ops.neighbors import block_pair_forces, nlist_pair_forces
            sweep = (block_pair_forces if self.ncfg.block
                     else nlist_pair_forces)
            f, evdwl, ecoul, overflow = sweep(
                self.ncfg, nbr, x, q, self.type_idx, self.tables,
                self.exclusions, g_ewald=self.ksp_force.g_ewald,
                qqr2e=u.qqr2e)
            evdwl = jnp.where(overflow, jnp.nan, evdwl)
            ecoul = jnp.where(overflow, jnp.nan, ecoul)
        elif self.cell_grid is not None:
            from ..ops.cells import cell_pair_forces
            f, evdwl, ecoul, overflow = cell_pair_forces(
                self.cell_grid, x, q, self.type_idx, self.tables,
                self.exclusions, g_ewald=self.ksp_force.g_ewald, qqr2e=u.qqr2e)
            # fail loud on cell overflow: poison the energy (checked by
            # callers/bench; silent truncation would corrupt physics)
            evdwl = jnp.where(overflow, jnp.nan, evdwl)
            ecoul = jnp.where(overflow, jnp.nan, ecoul)
        else:
            f, evdwl, ecoul = dense_pair_forces(
                x, q, self.type_idx, self.tables, self.exclusions,
                box=box, periodic=sys.periodic, cutoff=self.md.cutoff,
                g_ewald=self.ksp_force.g_ewald, qqr2e=u.qqr2e)
        fba, eba = bonded_forces(
            x, jnp.asarray(sys.bonds), jnp.asarray(sys.bond_coeffs),
            jnp.asarray(sys.angles), jnp.asarray(sys.angle_coeffs),
            box=box, periodic=sys.periodic)
        if self.pppm_grid is not None:
            from ..ops import pppm as pppm_ops
            grid = self.pppm_grid
            is_ele = self.elecheck != 0
            rhok_elyte, slots = kcache if kcache is not None else (None, None)
            if slots is not None and slots.dxs.dtype != x.dtype:
                slots = None       # solve ran in a different precision
            cplx = jnp.complex64 if x.dtype == jnp.float32 else jnp.complex128
            if rhok_elyte is not None and rhok_elyte.dtype != cplx:
                rhok_elyte = None  # rebuild the mesh in the force dtype
            tiled = not pppm_ops._use_dense(grid, x.shape[0])
            if self.conp is not None:
                if rhok_elyte is None:
                    q_elyte = jnp.where(is_ele, 0.0, q)
                    if tiled and slots is None:
                        slots = (pppm_ops.refresh_tile_slots(
                                     grid, tasg, x, q_elyte)
                                 if tasg is not None
                                 else pppm_ops.tile_slots(grid, x, q_elyte))
                    rhok_elyte = pppm_ops.spread_rhok(
                        grid, x, q_elyte, slots=slots)
                # re-spread only the Ne electrode rows (pppm_conp.cpp:385-426
                # ele_make_rho) and add their density IN K-SPACE: with the
                # z-plane fast path the electrode forward transform is P
                # tiny 2-D FFTs + a small z-DFT matmul, so the force path
                # pays no full forward FFT at all (the electrolyte rhok is
                # cached from the charge solve)
                xe = self.conp._ele_rows(x)
                qe = self.conp._ele_rows(q)
                if self.conp.ele_zplanes is not None:
                    rho_ep = pppm_ops.spread_zplanes(
                        grid, xe, qe, self.conp.ele_zpinv)
                    rhok = rhok_elyte + pppm_ops.rhok_from_zplanes(
                        grid, rho_ep, self.conp.ele_zplanes)
                else:
                    rhok = rhok_elyte + pppm_ops.rfft3(
                        grid, pppm_ops.spread(grid, xe, qe))
            else:
                if tiled and slots is None:
                    slots = (pppm_ops.refresh_tile_slots(grid, tasg, x, q)
                             if tasg is not None
                             else pppm_ops.tile_slots(grid, x, q))
                rhok = pppm_ops.spread_rhok(grid, x, q, slots=slots)
            if self.md.pppm_diff == "ad" or (
                    self.md.pppm_diff == "auto" and tiled):
                # ad differentiation: one inverse FFT + one-mesh gather
                # (MDConfig.pppm_diff; LAMMPS kspace_modify diff ad)
                if tiled and x.dtype == jnp.float32:
                    # z-binned inverse: the z-IDFT lands directly on the
                    # patch rows the tiled gather reads (no dense u mesh)
                    ek, uz = pppm_ops.pppm_energy_u_zbin(
                        grid, rhok, x.shape[0])
                    fk = u.qqr2e * q[:, None] * pppm_ops.gather3_ad_zbin(
                        grid, uz, x, slots=slots)
                else:
                    ek, umesh = pppm_ops.pppm_energy_u_from_k(grid, rhok)
                    fk = u.qqr2e * q[:, None] * pppm_ops.gather3_ad(
                        grid, umesh, x, slots=slots)
            else:
                ek, efield = pppm_ops.pppm_energy_efield_from_k(grid, rhok)
                fk = u.qqr2e * q[:, None] * pppm_ops.gather3(
                    grid, efield, x, slots=slots)
            ek = ek * u.qqr2e
        elif self.fksp is not None:
            from ..ops import ewald_factored as ewf
            if ew_cache is not None:
                tabs, sre, sie = ew_cache
                ek, fk = ewf.energy_forces_cached(
                    self.fksp, q, tabs, sre, sie,
                    jnp.asarray(self.conp.ele_idx),
                    contig=self.conp.ele_contig)
            else:
                ek, fk = ewf.energy_forces_f(self.fksp, x, q)
            ek = ek * u.qqr2e
            fk = fk * u.qqr2e
        else:
            ek, fk = ewald_ops.ewald_energy_forces(x, q, self.ksp_force)
            ek = ek * u.qqr2e
            fk = fk * u.qqr2e
        g = self.ksp_force.g_ewald
        eself = -u.qqr2e * g / MY_PIS * jnp.sum(q * q)
        qsum = jnp.sum(q)
        ebg = -u.qqr2e * math.pi / (2 * g * g * self.ksp_force.volume) * qsum * qsum
        ek = ek + eself + ebg
        f = f + fba + fk
        pe = evdwl + ecoul + eba + ek

        if self.ksp_force.slabflag:
            es, fs = ewald_ops.slab_correction_energy_forces(
                x, q, self.ksp_force.volume)
            f = f + u.qqr2e * fs
            pe = pe + u.qqr2e * es

        # CONP post-force: Gaussian self energy + correction forces
        if self.conp is not None:
            kern = self.conp.kernels
            if self.ncfg is not None and nbr is not None:
                # electrode rows of the Verlet list: O(Ne*K)
                from ..ops.neighbors import conp_correction_from_list
                fc, ecorr = conp_correction_from_list(
                    self.ncfg, nbr, x, q, jnp.asarray(self.conp.ele_idx),
                    self.conp.elyte_mask, self.type_idx,
                    kern.force, kern.potential,
                    cutoff=self.md.cutoff, qqr2e=u.qqr2e)
            else:
                fc, ecorr = conp_correction_forces(
                    x, q, self.elecheck, kern.force, kern.potential,
                    self.type_idx, box=box, periodic=sys.periodic,
                    cutoff=self.md.cutoff, qqr2e=u.qqr2e,
                    ele_idx=jnp.asarray(self.conp.ele_idx))
            f = f + fc
            # dtype= : self_diag is host f64 and would silently promote the
            # whole potential energy to f64 under enable_x64 (scan carries
            # then type-mismatch against the f32 state)
            qsq_ele = jnp.sum(jnp.where(
                self.elecheck != 0,
                jnp.asarray(kern.self_diag, q.dtype) * q * q, 0.0))
            # ETA: qqr2e*eta*sum q^2/(sqrt2*sqrt(pi)) == qqr2e/2 * sum(self_diag q^2)
            # EHGO: qqr2e*sum u0_i q^2 == qqr2e * sum(self_diag q^2)
            fac = 0.5 if self.conp.cfg.pairmode is PairMode.ETA else 1.0
            pe = pe + u.qqr2e * fac * qsq_ele + ecorr

        # external / feedback uniform field (V/Angstrom): F = q E qe2f
        if self.md.efield is not None:
            e = jnp.asarray(self.md.efield, x.dtype)
            f = f + u.qe2f * q[:, None] * e[None, :]
        if self.md.efield_feedback:
            lz = self.system.box[2]
            ez = -scalar_out / lz
            f = f.at[:, 2].add(u.qe2f * q * ez)
        return f, pe

    # --------------------------------------------------------------- step
    def step(self, state: MDState) -> MDState:
        itg = self.integrator
        x, v, q = state.x, state.v, state.q
        v, xi, vxi = itg.thermostat_half(v, state.nhc_xi, state.nhc_vxi, state.step)
        v = itg.kick(v, state.f)
        x_old = x
        x = itg.drift(x_old, v)
        if self.cons is not None:
            x, dv = shake_positions(self.cons, x, x_old, itg.dt,
                                    box=self.ksp_force.box,
                                    periodic=self.system.periodic)
            v = v + dv
        if self.zmirror is not None:
            x = self.zmirror.apply(x, state.step + 1)

        nbr = state.nbr
        tasg = state.tasg
        if self.ncfg is not None:
            # Verlet-skin reneighbor check inside the jitted step (LAMMPS
            # Neighbor::check_distance); both cond branches return the same
            # static shapes.  The persistent mesh-tile assignment shares the
            # trigger: the skin bound that keeps the list exact also keeps
            # every atom inside its tile's drift margin (gated at
            # build_engine: skin/2 <= dm * min cell).
            from ..ops.neighbors import build_neighbor_list, needs_rebuild

            def rebuild(xx):
                nb = build_neighbor_list(self.ncfg, xx, self.tables,
                                         self.type_idx)
                if self.mesh_persist:
                    from ..ops import pppm as pppm_ops
                    return nb, pppm_ops.tile_assign(self.pppm_grid, xx)
                return nb, tasg

            nbr, tasg = jax.lax.cond(
                needs_rebuild(self.ncfg, nbr, x),
                rebuild, lambda xx: (nbr, tasg), x)
            # sticky overflow: once the capacity is exceeded the physics is
            # NaN-poisoned, and a later rebuild from NaN positions would
            # silently clear the flag — keep it set so the host-boundary
            # recovery in run() can identify overflow as the cause
            nbr = nbr._replace(overflow=nbr.overflow | state.nbr.overflow)

        scalar = state.scalar_out
        kcache = None
        if self.conp is not None:
            nevery = self.conp.cfg.nevery
            if nevery == 1:
                q, scalar, kcache = self.conp.solve_full(
                    x, q, state.step + 1, nbr, self.ncfg,
                    scalar_prev=state.scalar_out, tasg=tasg)
            elif jnp.dtype(self.conp.solve_dtype) == jnp.dtype(self.dtype):
                # the skip branch still builds the electrolyte mesh cache
                # (same work the force path would otherwise redo) so BOTH
                # branches return an identically-shaped kcache and the
                # pppm_conp.cpp:428-450 reuse invariant holds on solve
                # steps too
                q, scalar, kcache = jax.lax.cond(
                    (state.step + 1) % nevery == 0,
                    lambda: self.conp.solve_full(
                        x, q, state.step + 1, nbr, self.ncfg,
                        scalar_prev=state.scalar_out, tasg=tasg),
                    lambda: (q, scalar,
                             self.conp.elyte_kcache(x, q, tasg)))
            else:
                # mixed precision (solve_dtype != engine dtype):
                # compute_forces would discard a solve-dtype cache anyway —
                # don't pay the skip branch's spread + FFT twice
                q, scalar = jax.lax.cond(
                    (state.step + 1) % nevery == 0,
                    lambda: self.conp.solve_full(
                        x, q, state.step + 1, nbr, self.ncfg,
                        scalar_prev=state.scalar_out, tasg=tasg)[:2],
                    lambda: (q, scalar))

        f, pe = self.compute_forces(x, q, scalar, kcache, nbr, tasg)
        v = itg.kick(v, f)
        if self.cons is not None:
            v = rattle_velocities(self.cons, x, v, box=self.ksp_force.box,
                                  periodic=self.system.periodic)
        v, xi, vxi = itg.thermostat_half(v, xi, vxi, state.step)
        return MDState(x=x, v=v, q=q, f=f, step=state.step + 1,
                       nhc_xi=xi, nhc_vxi=vxi, scalar_out=scalar, energy=pe,
                       nbr=nbr, tasg=tasg)

    # -------------------------------------------------------------- setup
    def init_state(self, x0=None, v0=None, q0=None) -> MDState:
        """setup: zero electrode velocities, initial charge solve, first forces.

        Runs as ONE jitted program instead of ~100 eager dispatches."""
        dt = self.dtype
        x = jnp.asarray(self.system.x0 if x0 is None else x0, dt)
        v = jnp.asarray(self.system.v0 if v0 is None else v0, dt)
        q = jnp.asarray(self.system.q0 if q0 is None else q0, dt)
        go = self._run_cache.get("_init")
        if go is None:
            nt = max(len(self.integrator.thermostats), 1)
            tch = (self.integrator.thermostats[0].tchain
                   if self.integrator.thermostats else 3)

            @jax.jit
            def go(x, v, q):
                # `velocity ele set 0` + frozen non-integrated atoms: zero
                # everything the integrator won't move
                v = jnp.where(self.integrator.mobile_mask[:, None], v, 0.0)
                scalar = jnp.zeros((), dt)
                kcache = None
                nbr = None
                tasg = None
                if self.ncfg is not None:
                    from ..ops.neighbors import build_neighbor_list
                    nbr = build_neighbor_list(self.ncfg, x, self.tables,
                                              self.type_idx)
                if self.mesh_persist:
                    from ..ops import pppm as pppm_ops
                    tasg = pppm_ops.tile_assign(self.pppm_grid, x)
                if self.conp is not None:
                    q, scalar, kcache = self.conp.solve_full(
                        x, q, jnp.zeros((), jnp.int32), nbr, self.ncfg,
                        tasg=tasg)
                f, pe = self.compute_forces(x, q, scalar, kcache, nbr, tasg)
                return MDState(
                    x=x, v=v, q=q, f=f, step=jnp.zeros((), jnp.int32),
                    nhc_xi=jnp.zeros((nt, tch), dt),
                    nhc_vxi=jnp.zeros((nt, tch), dt),
                    scalar_out=scalar, energy=pe, nbr=nbr, tasg=tasg)

            self._run_cache["_init"] = go
        return go(x, v, q)

    # ---------------------------------------------------------------- run
    def thermo(self, state: MDState):
        """One row of thermo scalars matching the reference decks'
        ``thermo_style custom step temp c_tempsl c_qleft c_qright c_dipole
        f_e`` (tests/cond/input:74): all-atom T, solvent-group T
        (compute tempsl sol temp, input:46), electrode charges, electrolyte
        dipole sum(q*z) over sol (compute dipole sol reduce sum v_qz,
        input:36+48), fix scalar, potential energy."""
        u = self.system.units()
        nall = self.system.natoms
        ncons = 0 if self.cons is None else self.cons.ncons
        dof_all = 3 * nall - 3 - ncons
        t_all = group_temperature(state.v, self.integrator.mass,
                                  jnp.ones(nall, bool), float(dof_all), u)
        sol = self.system.groups.get("sol")
        if sol is None and self.md.thermostats:
            sol = self.system.groups[self.md.thermostats[0].group]
        if sol is not None:
            nsol = int(np.sum(sol))
            ncons_sol = 0 if self.cons is None else self.cons.n_in_group(sol)
            dof_sol = 3 * nsol - 3 - ncons_sol
            t_sl = group_temperature(state.v, self.integrator.mass,
                                     jnp.asarray(sol), float(dof_sol), u)
            dipole = jnp.sum(jnp.where(jnp.asarray(sol),
                                       state.q * state.x[:, 2], 0.0))
        else:
            t_sl = t_all
            dipole = jnp.sum(state.q * state.x[:, 2])
        lmask = jnp.asarray(self.system.ele_left_mask)
        rmask = jnp.asarray(self.system.ele_right_mask)
        qleft = jnp.sum(jnp.where(lmask, state.q, 0.0))
        qright = jnp.sum(jnp.where(rmask, state.q, 0.0))
        return dict(step=state.step, temp=t_all, tempsl=t_sl, qleft=qleft,
                    qright=qright, dipole=dipole, f_e=state.scalar_out,
                    pe=state.energy)

    def _make_run(self, nsteps: int, thermo_every: int = 1):
        if thermo_every == 0:
            # no thermo at all: a pure chained fori_loop.  Callers that only
            # want the final state (bench warmup/measure, equilibration)
            # should never pay the per-step thermo reductions nor the extra
            # compiled scan carrying them.
            return jax.jit(lambda st: (jax.lax.fori_loop(
                0, nsteps, lambda i, s: self.step(s), st), None))
        if thermo_every > 1 and nsteps % thermo_every == 0:
            # thermo only at interval boundaries: outer scan over chunks,
            # inner fori_loop of raw steps: never compute thermo rows that
            # the caller would slice away.
            def chunk(st, _):
                st = jax.lax.fori_loop(
                    0, thermo_every, lambda i, s: self.step(s), st)
                return st, self.thermo(st)

            return jax.jit(lambda st: jax.lax.scan(
                chunk, st, None, length=nsteps // thermo_every))

        def body(st, _):
            st = self.step(st)
            return st, self.thermo(st)

        return jax.jit(lambda st: jax.lax.scan(body, st, None, length=nsteps))

    def compile_run(self, state: MDState, nsteps: int,
                    thermo_every: int = 1):
        """AOT-compile the nsteps scan for ``state``'s shapes so a following
        run() call executes without paying the compile — lets callers time
        device throughput apart from compilation.  Returns the compiled
        executable (memory_analysis(), cost_analysis())."""
        key = (nsteps, thermo_every)
        if key not in self._run_cache:
            self._run_cache[key] = \
                self._make_run(nsteps, thermo_every).lower(state).compile()
        return self._run_cache[key]

    def _grow_neighbor_capacity(self) -> None:
        """Grow the Verlet-list K and cell-table capacity after an overflow
        and drop the compiled programs (shapes change).  The analogue of
        LAMMPS's neighbor-page reallocation (SURVEY.md section 2.3-1)."""
        if self.ncfg is not None:
            g = self.ncfg.grid
            grid = dataclasses.replace(g, cap=2 * g.cap)
            object.__setattr__(self, "ncfg", dataclasses.replace(
                self.ncfg, grid=grid, k_max=2 * self.ncfg.k_max,
                u_max=2 * self.ncfg.u_max))
        elif self.cell_grid is not None:
            g = self.cell_grid
            object.__setattr__(self, "cell_grid",
                               dataclasses.replace(g, cap=2 * g.cap))
        self._run_cache.clear()

    def _mesh_tiled(self) -> bool:
        from ..ops import pppm as pppm_ops
        return (self.pppm_grid is not None
                and not pppm_ops._use_dense(self.pppm_grid,
                                            self.system.natoms))

    def _grow_tile_capacity(self) -> None:
        """Grow the mesh tile slot capacity after an occupancy overflow.
        The tiled spread/gather NaN-poisons on overflow (TileSlots.overflow)
        but no sticky flag reaches the state, so run() retries bounded on
        any NaN without a neighbor overflow — a genuine physics NaN just
        re-fails and exits after the bounded retries."""
        from ..ops import pppm as pppm_ops
        g = self.pppm_grid
        geom = pppm_ops._tile_geometry(g, self.system.natoms)
        g2 = dataclasses.replace(
            g, tile_cap=min(2 * geom.cap, self.system.natoms + 1))
        object.__setattr__(self, "pppm_grid", g2)
        if self.conp is not None and self.conp.pppm_grid is not None:
            object.__setattr__(self.conp, "pppm_grid", g2)
        self._run_cache.clear()

    def run(self, state: MDState, nsteps: int, *, thermo_every: int = 1):
        """jit + lax.scan main loop; returns (final_state, thermo pytree).

        If the run NaN-poisons through a neighbor-capacity overflow (sticky
        ``nbr.overflow``), the capacity is grown and the whole chunk re-runs
        from the entry state — a long production run recovers instead of
        dying (LAMMPS reallocates neighbor storage; SURVEY.md 2.3-1)."""
        key = (nsteps, thermo_every)
        chunked = thermo_every > 1 and nsteps % thermo_every == 0

        def execute(st):
            go = self._run_cache.get(key)
            if go is None:
                go = self._make_run(nsteps, thermo_every)
                self._run_cache[key] = go
            return go(st)

        final, th = execute(state)
        for _ in range(3):
            if np.isfinite(float(final.energy)):
                break
            if self.ncfg is not None and state.nbr is not None and \
                    bool(final.nbr.overflow):
                self._grow_neighbor_capacity()
            elif self._mesh_tiled() or self.cell_grid is not None:
                # no sticky flag distinguishes mesh-tile from cell-table
                # overflow (or a genuine physics NaN) — grow whichever
                # capacities are in play, bounded by the retry count
                if self._mesh_tiled():
                    self._grow_tile_capacity()
                if self.cell_grid is not None:
                    self._grow_neighbor_capacity()
            else:
                break
            state = self._heal_state(state)
            final, th = execute(state)
        if thermo_every > 1 and not chunked:
            th = jax.tree.map(lambda a: a[thermo_every - 1::thermo_every], th)
        return final, th

    def _heal_state(self, state: MDState) -> MDState:
        """Rebuild all DERIVED state (neighbor list, electrode charges,
        forces) from (x, v) with the current — possibly grown — capacities.
        Positions/velocities/thermostat state pass through; NaN-poisoned
        q[ele]/f from an overflowed entry state are overwritten (the charge
        solve masks electrode charges out of b, so stale NaNs don't
        propagate)."""
        from ..ops.neighbors import build_neighbor_list

        @jax.jit
        def heal(st: MDState) -> MDState:
            nbr = None
            tasg = None
            if self.ncfg is not None:
                nbr = build_neighbor_list(self.ncfg, st.x, self.tables,
                                          self.type_idx)
            if self.mesh_persist:
                from ..ops import pppm as pppm_ops
                tasg = pppm_ops.tile_assign(self.pppm_grid, st.x)
            q, scalar, kcache = st.q, st.scalar_out, None
            if self.conp is not None:
                q, scalar, kcache = self.conp.solve_full(
                    st.x, st.q, st.step, nbr, self.ncfg,
                    scalar_prev=st.scalar_out, tasg=tasg)
            f, pe = self.compute_forces(st.x, q, scalar, kcache, nbr, tasg)
            return st._replace(q=q, f=f, scalar_out=scalar, energy=pe,
                               nbr=nbr, tasg=tasg)

        return heal(state)


def build_engine(system: System, md: MDConfig, conp: Optional[ConpSolver] = None,
                 *, dtype=jnp.float64) -> Engine:
    u = system.units()
    # force-path kspace: reuse the conp solver's tables if present (same
    # accuracy source), else build from MDConfig
    if conp is not None:
        ksp = conp.ksp
    else:
        q2 = float((system.q0 ** 2).sum()) * u.qqr2e
        acc_abs = md.kspace_accuracy * u.qqr2e
        slabflag = md.slab is not None
        g = md.g_ewald or ewald_ops.determine_g_ewald_box(
            acc_abs, md.cutoff, system.natoms, max(q2, 1e-10), *system.box)
        ksp = ewald_ops.setup_ewald(
            box=system.box, accuracy_abs=acc_abs, g_ewald=g,
            natoms=system.natoms, q2=max(q2, 1e-10),
            slabflag=slabflag, slab_volfactor=md.slab if slabflag else 1.0)

    cons = build_constraints(system, md.shake)
    thermos = []
    for tc in md.thermostats:
        gmask = system.groups[tc.group]
        ncons_g = 0
        if cons is not None:
            ncons_g = cons.n_in_group(gmask)
        thermos.append(make_nhc_params(
            gmask, tc.t_start, tc.t_stop, tc.damp,
            nconstraints=ncons_g, tchain=tc.tchain))

    # LAMMPS semantics: only atoms in some integrator fix move.  All the
    # reference decks integrate exactly the thermostatted groups (`fix nvt`);
    # everything else (electrodes INCLUDING non-conp outer layers, e.g.
    # il_twolayer mol 643+) stays frozen.
    if md.thermostats:
        mobile = np.zeros(system.natoms, bool)
        for tc in md.thermostats:
            mobile |= system.groups[tc.group]
    else:
        mobile = system.mobile_mask
    integrator = Integrator(
        dt=md.dt, units=u, mass=jnp.asarray(system.mass, dtype),
        mobile_mask=jnp.asarray(mobile), thermostats=tuple(thermos))

    pppm_grid = None
    if conp is not None and conp.pppm_grid is not None:
        pppm_grid = conp.pppm_grid
    elif md.kspace_style.name == "PPPM":
        from ..ops import pppm as pppm_ops
        q2 = float((system.q0 ** 2).sum()) * u.qqr2e
        pppm_grid = pppm_ops.setup_pppm(
            box=system.box, box_lo=tuple(system.box_lo),
            accuracy_abs=md.kspace_accuracy * u.qqr2e, natoms=system.natoms,
            q2=max(q2, 1e-10), cutoff=md.cutoff,
            slabflag=md.slab is not None,
            slab_volfactor=md.slab if md.slab is not None else 1.0,
            g_ewald=ksp.g_ewald)
        # occupancy-measured tile slot capacity (see setup_conp)
        pppm_grid = pppm_ops.with_tile_cap(pppm_grid, system.x0)

    cell_grid = None
    ncfg = None
    big_n = (system.natoms > 8192 and
             all(b >= 4.0 * md.cutoff for b in system.box))
    # auto selects exactly ONE path: the per-atom Verlet list at large N,
    # the dense sweep otherwise; building several would carry dead lists
    # through every step (~200 MB at 100k).  The block form is opt-in (the
    # sharded engine shards it along the block axis).
    want_cell = md.pair_path == "cell"
    want_block = md.pair_path == "block"
    want_nlist = (want_block or md.pair_path == "nlist" or
                  (md.pair_path == "auto" and big_n))
    if want_cell:
        from ..ops.cells import build_cell_grid
        cell_grid = build_cell_grid(system.box, tuple(system.box_lo),
                                    md.cutoff, system.natoms,
                                    periodic=system.periodic)
    if want_nlist:
        from ..ops.neighbors import make_neighbor_config
        ncfg = make_neighbor_config(
            system.box, tuple(system.box_lo), md.cutoff, system.natoms,
            periodic=system.periodic, skin=md.neighbor_skin,
            k_max=md.neighbor_kmax, x0=system.x0,
            block=8 if want_block else 0)
        if ncfg.block:
            # size U from the EXACT max block-union width at x0 (1.3x
            # headroom, lane-rounded) — same policy as the k_max sizing in
            # make_neighbor_config; the heuristic there only covers the
            # no-positions case.  One extra jitted list build at setup.
            from ..ops.neighbors import build_neighbor_list, max_union_count
            base = dataclasses.replace(ncfg, block=0, u_max=0)
            tbl0 = make_pair_tables(system.lj_eps, system.lj_sigma,
                                    system.type, dtype)
            nl0 = jax.jit(build_neighbor_list, static_argnums=(0,))(
                base, jnp.asarray(system.x0, dtype), tbl0,
                jnp.asarray(system.type))
            ucnt = max_union_count(ncfg, jnp.asarray(system.x0, dtype), nl0)
            ncfg = dataclasses.replace(
                ncfg, u_max=int(np.ceil(ucnt * 1.3 / 8.0) * 8) + 8)

    zmirror = None
    if md.zmirror is not None:
        from .zmirror import build_zmirror
        zmirror = build_zmirror(system, md.zmirror.group1, md.zmirror.group2,
                                md.zmirror.every)

    fksp = None
    if pppm_grid is None:
        from ..ops.ewald_factored import factorize
        fksp = factorize(ksp)

    # persistent mesh-tile binning: the Verlet skin trigger bounds drift by
    # skin/2 between rebuilds, so the assignment stays exact iff skin/2 fits
    # inside the tile drift margin on every axis (else fall back to per-step
    # binning — correctness over amortization)
    mesh_persist = False
    if pppm_grid is not None and ncfg is not None:
        from ..ops import pppm as pppm_ops
        if not pppm_ops._use_dense(pppm_grid, system.natoms):
            g = pppm_grid
            min_cell = min(g.box[0] / g.nx, g.box[1] / g.ny,
                           g.zprd_grid / g.nz)
            mesh_persist = 0.5 * ncfg.skin <= pppm_ops.TILE_DM * min_cell

    return Engine(
        system=system, md=md, conp=conp, integrator=integrator, cons=cons,
        ksp_force=ksp, pppm_grid=pppm_grid, zmirror=zmirror, fksp=fksp,
        cell_grid=cell_grid, ncfg=ncfg,
        type_idx=jnp.asarray(system.type),
        exclusions=tuple(jnp.asarray(a) for a in exclusion_lists(system)),
        tables=make_pair_tables(system.lj_eps, system.lj_sigma, system.type, dtype),
        elecheck=jnp.asarray(system.elecheck),
        dtype=dtype,
        mesh_persist=mesh_persist,
    )

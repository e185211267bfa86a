"""Multi-chip sharded MD step via shard_map over a 1-D device mesh.

Parallelization strategy — the re-expression of the reference's MPI
decomposition (SURVEY.md section 2.3/2.4):

  * dynamic state (x, v, q) is REPLICATED — at CONP scales the state is tiny
    (MBs) while the per-step work is large (N*K transcendentals, N^2 pairs);
  * the k axis is SHARDED: each chip owns K/D k-vectors and computes partial
    structure factors, partial k-space forces, and partial electrode
    potentials -> one psum((N,3)) + psum((Ne,)).  This replaces
    ``MPI_Allreduce(sfacrl/sfacim)`` (km_ewald.cpp:782-786) with the dual
    (shard k, not atoms) — cheaper because the reduction payload is the
    force array, not the K-long structure factor;
  * pair-interaction ROWS are sharded: each chip computes forces on N/D
    atoms against all atoms -> all_gather((N/D,3)) == LAMMPS's spatial
    decomposition without ghosts;
  * A^-1 ROWS are sharded: each chip stores (Ne/D, Ne) and computes its rows
    of A^-1 b -> all_gather — exactly the split-Ewald distribution
    (km_ewald_split.cpp:616-667, fix_conp.cpp:1132-1141) minus the
    round-robin broadcasts.

No hand-rolled barriers anywhere: XLA orders the collectives.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.md import Engine
from ..models.system import MDState
from ..ops import ewald as ewald_ops
from ..ops.erfc import erfcr_sqrt
from ..ops.pairs import min_image, pair_rowblock
from ..utils.config import Mode, PairMode


def _pad_to(arr, mult, axis=0):
    n = arr.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(np.asarray(arr), widths)


@dataclasses.dataclass(frozen=True)
class ShardedEngine:
    """Holds the sharded constants and the shard_map'd step."""
    engine: Engine
    mesh: Mesh
    axis: str
    step_fn: object          # jitted (state, shards) -> state
    shards: tuple            # device-sharded constant pytree
    tasg_fn: object = None   # jitted x -> stacked per-device TileAssign
    #                          (None when the sharded mesh binning is not
    #                          persistent)
    tasg_table_shape: tuple = None   # expected stacked table shape — lets
    #                          _prep_state recognize (and keep) an already-
    #                          sharded assignment on repeated step() calls

    def _prep_state(self, state: MDState) -> MDState:
        """Normalize an Engine.init_state state for the sharded step:

        * when the engine's list has no block form (ncfg.block == 0) but
          the state carries block fields, strip them (branch-structure
          compatibility); with ncfg.block the sharded sweep consumes them
          directly (block_pair_rows) and the sharded rebuild re-attaches
          them — the single-chip fast path is kept, differently
          distributed (km_ewald_split.cpp:551-667 shares all of
          km_ewald's optimized math);
        * replace the (single-chip-geometry) mesh-tile assignment with the
          stacked per-device one, or None when not persistent here."""
        nbr = state.nbr
        keep_block = (self.engine.ncfg is not None
                      and getattr(self.engine.ncfg, "block", 0))
        if (nbr is not None and getattr(nbr, "bun", None) is not None
                and not keep_block):
            state = state._replace(nbr=nbr._replace(
                bun=None, brows=None, binv=None, bcr=None, btu=None))
        if self.tasg_fn is not None:
            t = state.tasg
            # the overflow rank distinguishes a single-chip assignment
            # (scalar) from the stacked per-device one ((d,)) even when
            # d == 1 makes the table shapes collide
            if (t is None or tuple(t.table.shape) != self.tasg_table_shape
                    or jnp.ndim(t.overflow) != 1):
                state = state._replace(tasg=self.tasg_fn(state.x))
        elif state.tasg is not None:
            state = state._replace(tasg=None)
        return state

    def step(self, state: MDState) -> MDState:
        return self.step_fn(self._prep_state(state), *self.shards)

    def run(self, state: MDState, nsteps: int, *, thermo_every: int = 0):
        """Scan nsteps; with thermo_every > 0 also returns the thermo rows
        (same schema as Engine.thermo) subsampled every thermo_every steps."""
        shards = self.shards
        eng = self.engine
        state = self._prep_state(state)

        @jax.jit
        def go(st):
            def body(s, _):
                s = self.step_fn(s, *shards)
                out = eng.thermo(s) if thermo_every else 0
                return s, out
            return jax.lax.scan(body, st, None, length=nsteps)

        final, th = go(state)
        if thermo_every:
            th = jax.tree.map(lambda a: a[thermo_every - 1::thermo_every], th)
            return final, th
        return final


def build_sharded_engine(engine: Engine, mesh: Mesh, *, axis: str = "s") -> ShardedEngine:
    d = mesh.shape[axis]
    sys = engine.system
    n = sys.natoms
    u = sys.units()
    conp = engine.conp
    dtype = np.float64 if engine.dtype == jnp.float64 else np.float32

    # ---- shardable constants, padded to D multiples -------------------
    # factored Ewald: shard the kxy axis (pad rows get ug=0 -> no contribution)
    # in PPPM mode the engine carries no factored tables, but the CG_MATFREE
    # electrode operator still uses them (exact-Ewald A + mesh b, the
    # pppm_conp.cpp:91-101 split) — take the solver's
    fk = engine.fksp if engine.fksp is not None else (
        conp.fksp if conp is not None else None)
    if fk is not None:
        kvecs = _pad_to(fk.kxy.astype(np.int64), d)                # (nxy', 2)
        ug = _pad_to(fk.ug.astype(dtype), d)                       # (nxy', nz)
    else:
        kvecs = np.zeros((d, 2), np.int64)
        ug = np.zeros((d, 1), dtype)
    exi0, exv0 = engine.exclusions
    exi = _pad_to(np.asarray(exi0), d).copy()                      # (N', m), pad rows
    exi[n:] = n
    exv = _pad_to(np.asarray(exv0, dtype), d)
    xpadmask = np.zeros(exi.shape[0], bool)
    xpadmask[:n] = True                                            # valid-row mask (N',)

    from ..utils.config import Solver as _Solver
    ele_idx = conp.ele_idx if conp is not None else np.zeros(0, np.int64)
    ne = len(ele_idx)
    if conp is not None:
        # the row-sharded solve matrix depends on the solver:
        #   INV        -> A^-1 rows  (matvec + all_gather)
        #   CG         -> A rows     (distributed A.p inside the CG loop)
        #   CG_MATFREE -> real-space erfc block rows (k-space applied
        #                 matrix-free over the k shard; km_ewald_split.cpp's
        #                 distributed-operator semantics, :616-667)
        if conp.cfg.solver is _Solver.CG:
            solve_mat = conp.ctx.amat
        elif conp.cfg.solver is _Solver.CG_MATFREE:
            solve_mat = conp.ctx.real_block
        else:
            solve_mat = conp.ctx.ainv
        asolve = _pad_to(np.asarray(solve_mat, dtype), d)          # (Ne', Ne)
        ele_idx_p = _pad_to(ele_idx, d)                            # (Ne',)
        # pad rows must point at a REAL electrode (results are masked by
        # ele_valid, but the z-plane gather fail-loud check would trip on
        # an arbitrary atom-0 position)
        ele_idx_p[ne:] = ele_idx[0]
        ele_valid = np.zeros(len(ele_idx_p), bool)
        ele_valid[:ne] = True
    else:
        asolve = np.zeros((d, 1), dtype)
        ele_idx_p = np.zeros(d, np.int64)
        ele_valid = np.zeros(d, bool)

    sh = NamedSharding(mesh, P(axis))
    sh2 = NamedSharding(mesh, P(axis, None))
    shards = (
        jax.device_put(jnp.asarray(kvecs), sh2),
        jax.device_put(jnp.asarray(ug), sh2),
        jax.device_put(jnp.asarray(exi), sh2),
        jax.device_put(jnp.asarray(exv), sh2),
        jax.device_put(jnp.asarray(xpadmask), sh),
        jax.device_put(jnp.asarray(asolve), sh2),
        jax.device_put(jnp.asarray(ele_idx_p), sh),
        jax.device_put(jnp.asarray(ele_valid), sh),
    )

    ksp = engine.ksp_force
    box = ksp.box
    periodic = sys.periodic
    itg = engine.integrator
    type_idx = engine.type_idx
    elecheck = engine.elecheck
    md = engine.md
    qqr2e = u.qqr2e

    nrow = exi.shape[0] // d           # atom rows per device
    nele_row = asolve.shape[0] // d    # electrode rows per device

    # ------------------------------------------------------------------
    npad_rows = exi.shape[0] - n       # row padding so N' = d * nrow

    # ---- shard-local PPPM tile geometry + persistent assignment -------
    # Each device bins only its nrow atom rows, so the per-tile slot
    # capacity can be sized from the actual per-shard occupancy instead of
    # the whole-system tile_cap (which with_tile_cap baked for N atoms —
    # using it per shard would cost every device the FULL single-chip
    # spread/gather matmul flops).  Index-sliced rows are NOT spatially
    # uniform (electrode planes are contiguous index runs), so measure the
    # max occupancy over the actual shards at x0 (+25% headroom; the
    # tiled ops NaN-poison on overflow — fail loud, like everywhere else).
    grid_g = engine.pppm_grid
    grid_l = grid_g
    mesh_persist_l = False
    if grid_g is not None:
        from ..ops import pppm as pppm_ops
        # gate on the GLOBAL system's dense/tiled choice (not the shard's
        # nrow): single-chip and sharded then always run the same
        # discretization family, and the per-shard cap sizing below keeps
        # the tiled matmuls shard-sized
        if not pppm_ops._use_dense(grid_g, n):
            x0p = _pad_to(np.asarray(sys.x0, dtype), d)
            if npad_rows:
                x0p[n:] = x0p[n - 1]       # edge-pad: stay inside the box
            occ = max(pppm_ops.tile_occupancy(
                dataclasses.replace(grid_g, tile_cap=None),
                x0p[i * nrow:(i + 1) * nrow]) for i in range(d))
            cap_l = int(math.ceil(max(occ, 8) * 1.25 / 8.0) * 8)
            cap_l = min(cap_l, grid_g.tile_cap or cap_l, nrow + 1)
            grid_l = dataclasses.replace(grid_g, tile_cap=cap_l)
            # share the hoisted device-constant cache (greens etc.) so the
            # shard grid doesn't duplicate the 31 MB influence function
            cache = getattr(grid_g, "_devcache", None)
            if cache is None:
                cache = {}
                object.__setattr__(grid_g, "_devcache", cache)
            object.__setattr__(grid_l, "_devcache", cache)
            # persistent per-device tile assignment under the Verlet skin
            # trigger — the same skin/2 <= dm*cell gate as build_engine
            mesh_persist_l = bool(engine.mesh_persist
                                  and engine.ncfg is not None)

    # cell-list statics (sharded large-N pair path): each device sweeps a
    # contiguous slice of cell blocks; forces scatter to each cell's own
    # slots, so one psum((N,3)) reassembles the full array — the
    # re-expression of LAMMPS spatial decomposition (SURVEY.md 2.3-1)
    cell_grid = engine.cell_grid
    if cell_grid is not None:
        from ..ops import cells as cells_ops
        _cell_block = 32
        _C = cell_grid.total
        _nblk_tot = -(-_C // _cell_block)
        _nblk_loc = -(-_nblk_tot // d)             # blocks per device
        _padc = _nblk_loc * d * _cell_block - _C   # pad cells to d multiple

    def sharded_pairs(x, q, exi_l, exv_l, rvalid_l, i0, nbr=None):
        """Per-device pair sweep -> replicated (f (N,3), evdwl, ecoul)."""
        if (engine.ncfg is not None and cell_grid is None and nbr is not None
                and getattr(nbr, "bun", None) is not None):
            # block-compacted sweep, block axis sharded: each device runs
            # the single-chip block sweep on its contiguous block slice;
            # slot forces all_gather back and binv unscatters them — the
            # same pair set and math as block_pair_forces
            from ..ops import cells as cells_ops
            from ..ops import neighbors as nbr_ops
            nbp = nbr_ops.pad_block_list(nbr, n, d)
            nb_tot = nbp.bun.shape[0]
            nb_l = nb_tot // d
            b0 = jax.lax.axis_index(axis) * nb_l
            f_slots, ev_l, ec_l = nbr_ops.block_pair_rows(
                engine.ncfg, nbp, x, q, b0, nb_l,
                g_ewald=ksp.g_ewald, qqr2e=qqr2e)
            f_all = jax.lax.all_gather(f_slots, axis, axis=0, tiled=True)
            f = f_all[nbr.binv]
            ev = jax.lax.psum(ev_l, axis)
            ec = jax.lax.psum(ec_l, axis)
            df, dev, dec = cells_ops.exclusion_correction(
                x, q, type_idx, engine.tables, engine.exclusions,
                box=box, periodic=periodic, cutsq=md.cutoff ** 2,
                qqr2e=qqr2e)
            f = jnp.where(nbr.overflow, jnp.nan, f + df)
            ev = jnp.where(nbr.overflow, jnp.nan, ev + dev)
            # poison ec too — consistent fail-loud with single-chip
            # block_pair_forces
            return f, ev, jnp.where(nbr.overflow, jnp.nan, ec + dec)
        if engine.ncfg is not None and cell_grid is None and nbr is not None:
            # Verlet-list rows sharded over devices: each chip sweeps its
            # N/D rows of the (N, K) list, forces all_gather (the ghost-free
            # spatial decomposition, SURVEY.md 2.3-1)
            from ..ops import neighbors as nbr_ops
            idx_p = jnp.pad(nbr.idx, ((0, npad_rows), (0, 0)),
                            constant_values=n)
            lj_p = jnp.pad(nbr.lj, ((0, 0), (0, npad_rows), (0, 0)))
            xp_ = jnp.pad(x, ((0, npad_rows), (0, 0)))
            qp_ = jnp.pad(q, (0, npad_rows))
            xi_l = jax.lax.dynamic_slice_in_dim(xp_, i0, nrow)
            qi_l = jax.lax.dynamic_slice_in_dim(qp_, i0, nrow)
            idx_l = jax.lax.dynamic_slice_in_dim(idx_p, i0, nrow)
            lj_l = jax.lax.dynamic_slice_in_dim(lj_p, i0, nrow, axis=1)
            f_rows, ev_l, ec_l = nbr_ops.nlist_pair_rows(
                engine.ncfg, x, q, xi_l, qi_l, idx_l, lj_l,
                g_ewald=ksp.g_ewald, qqr2e=qqr2e)
            f = jax.lax.all_gather(f_rows, axis, axis=0, tiled=True)[:n]
            ev = jax.lax.psum(ev_l, axis)
            ec = jax.lax.psum(ec_l, axis)
            from ..ops import cells as cells_ops
            df, dev, dec = cells_ops.exclusion_correction(
                x, q, type_idx, engine.tables, engine.exclusions,
                box=box, periodic=periodic, cutsq=md.cutoff ** 2, qqr2e=qqr2e)
            f = jnp.where(nbr.overflow, jnp.nan, f + df)
            return f, ev + dev, ec + dec
        if cell_grid is not None:
            from ..ops import cells as cells_ops
            # replicated slot tables (one (C*cap)-row gather each); each
            # device then slab-sweeps only its own range of cell blocks
            table, xq, pt, overflow = cells_ops.cell_slab_tables(
                cell_grid, x, q, type_idx)
            cap = table.shape[1]
            xq_p, pt_p, nb_p, uq_p = cells_ops.pad_slab_tables(
                cell_grid, xq, pt, _padc, n)
            c0 = jax.lax.axis_index(axis) * (_nblk_loc * _cell_block)
            nb_l = jax.lax.dynamic_slice_in_dim(
                nb_p, c0, _nblk_loc * _cell_block)
            uq_l = jax.lax.dynamic_slice_in_dim(
                uq_p, c0, _nblk_loc * _cell_block)
            rows_l = jax.lax.dynamic_slice_in_dim(
                jnp.pad(table, ((0, _padc), (0, 0)), constant_values=n),
                c0, _nblk_loc * _cell_block)
            ev_l, ec_l, fb_l = cells_ops.sweep_cell_slabs(
                cell_grid, engine.tables, xq_p, pt_p,
                nb_l.reshape(_nblk_loc, _cell_block, 27),
                uq_l.reshape(_nblk_loc, _cell_block, 27),
                c0, g_ewald=ksp.g_ewald, qqr2e=qqr2e, n=n)
            # scatter my cells' slot forces, then psum((N,3)) over devices
            f_l = jnp.zeros((n + 1, 3), x.dtype).at[rows_l.reshape(-1)].add(
                fb_l.reshape(-1, 3))[:n]
            f = jax.lax.psum(f_l, axis)
            ev = jax.lax.psum(ev_l, axis)
            ec = jax.lax.psum(ec_l, axis)
            df, dev, dec = cells_ops.exclusion_correction(
                x, q, type_idx, engine.tables, engine.exclusions,
                box=box, periodic=periodic, cutsq=md.cutoff ** 2, qqr2e=qqr2e)
            f = f + df
            # fail loud on cell overflow, as the single-device path does
            ev = jnp.where(overflow, jnp.nan, ev + dev)
            return f, ev, ec + dec
        # dense: pair rows (my atoms vs all); slice from padded arrays so the
        # last device's block never clamps onto wrong atoms (pads are masked)
        xp = jnp.pad(x, ((0, npad_rows), (0, 0)))
        qp = jnp.pad(q, (0, npad_rows))
        tp = jnp.pad(type_idx, (0, npad_rows))
        xi = jax.lax.dynamic_slice_in_dim(xp, i0, nrow)
        qi = jax.lax.dynamic_slice_in_dim(qp, i0, nrow)
        ti = jax.lax.dynamic_slice_in_dim(tp, i0, nrow)
        f_rows, ev, ec = pair_rowblock(
            xi, qi, ti, exi_l, exv_l, rvalid_l, i0, x, q, type_idx, engine.tables,
            box=box, periodic=periodic, cutoff=md.cutoff,
            g_ewald=ksp.g_ewald, qqr2e=qqr2e)
        f = jax.lax.all_gather(f_rows, axis, axis=0, tiled=True)[:n]
        ev = jax.lax.psum(ev, axis)
        ec = jax.lax.psum(ec, axis)
        return f, ev, ec

    def _my_rows(x, q, i0):
        """(xi_l, qi_l): this device's padded atom-row slice.  Edge-pad
        positions: zero-filled pad atoms sit OUTSIDE the box when box_lo
        is positive and would trip the z-span binning's fail-loud
        out-of-box check (their q=0 keeps them physically inert)."""
        xp_ = jnp.pad(x, ((0, npad_rows), (0, 0)), mode="edge")
        qp_ = jnp.pad(q, (0, npad_rows))
        return (jax.lax.dynamic_slice_in_dim(xp_, i0, nrow),
                jax.lax.dynamic_slice_in_dim(qp_, i0, nrow))

    def _my_slots(xi_l, qi_l, tasg_l):
        """TileSlots of my rows: payload refresh under the persistent
        assignment when available, else the full packed-key sort."""
        from ..ops import pppm as pppm_ops
        if tasg_l is not None:
            return pppm_ops.refresh_tile_slots(grid_l, tasg_l, xi_l, qi_l)
        return pppm_ops.tile_slots(grid_l, xi_l, qi_l)

    def sharded_forces(x, q, scalar_out, kv_l, ug_l, exi_l, exv_l, rvalid_l,
                       i0, eidx_l, evalid_l, kcache=None, nbr=None,
                       tasg_l=None):
        """Per-device partial force computation; returns replicated (f, pe)."""
        f, ev, ec = sharded_pairs(x, q, exi_l, exv_l, rvalid_l, i0, nbr)

        if engine.pppm_grid is not None:
            # mesh k-space: spread sharded over atom rows with the SAME
            # fast paths as the single-chip engine (fused z-binned spread,
            # zbin ad gather — km_ewald_split.cpp:551-667 shares all of
            # km_ewald's optimized math), psum in k-space (linearity),
            # Poisson replicated.  When the solve ran this step, its
            # electrolyte rhok AND its per-device tile binning are reused;
            # only the Ne electrode charges are re-spread
            # (pppm_conp.cpp:428-450).
            from ..ops import pppm as pppm_ops
            xi_l, qi_l = _my_rows(x, q, i0)
            rhok_elyte, slots_l = (kcache if kcache is not None
                                   else (None, None))
            tiled = not pppm_ops._use_dense(grid_g, n)
            # the ad/ik choice must match what a SINGLE device would pick
            # for the global system (shard-invariance: ad and ik forces
            # differ by discretization, not rounding)
            tiled_global = not pppm_ops._use_dense(grid_g, n)
            if rhok_elyte is not None and conp is not None:
                # electrode density added in k-space (models/md.py
                # compute_forces): no full forward FFT in the force path
                eix = jnp.asarray(conp.ele_idx)
                if conp.ele_zplanes is not None:
                    rho_ep = pppm_ops.spread_zplanes(
                        grid_g, x[eix], q[eix], conp.ele_zpinv)
                    rhok = rhok_elyte + pppm_ops.rhok_from_zplanes(
                        grid_g, rho_ep, conp.ele_zplanes)
                else:
                    rhok = rhok_elyte + pppm_ops.rfft3(
                        grid_g, pppm_ops.spread(grid_g, x[eix], q[eix]))
            elif tiled and x.dtype == jnp.float32:
                # fused z-binned spread of my rows, psum'd in k-space
                if slots_l is None:
                    slots_l = _my_slots(xi_l, qi_l, tasg_l)
                rhok = jax.lax.psum(
                    pppm_ops.spread_rhok(grid_l, xi_l, qi_l, slots=slots_l),
                    axis)
            else:
                if tiled and slots_l is None:
                    slots_l = _my_slots(xi_l, qi_l, tasg_l)
                rhok = pppm_ops.rfft3(grid_g, jax.lax.psum(
                    pppm_ops.spread(grid_l, xi_l, qi_l, slots=slots_l),
                    axis))
            if md.pppm_diff == "ad" or (
                    md.pppm_diff == "auto" and tiled_global):
                # ad differentiation (MDConfig.pppm_diff): one inverse
                # transform + a one-mesh gather over my atom rows
                if tiled and x.dtype == jnp.float32:
                    # z-binned inverse straight onto my patch rows (the
                    # single-chip fast path at each device's shard)
                    ek, uz = pppm_ops.pppm_energy_u_zbin(grid_l, rhok, nrow)
                    f_rows = qi_l[:, None] * pppm_ops.gather3_ad_zbin(
                        grid_l, uz, xi_l, slots=slots_l)
                else:
                    ek, umesh = pppm_ops.pppm_energy_u_from_k(grid_g, rhok)
                    f_rows = qi_l[:, None] * pppm_ops.gather3_ad(
                        grid_l, umesh, xi_l, slots=slots_l)
            else:
                ek, efield = pppm_ops.pppm_energy_efield_from_k(grid_g, rhok)
                f_rows = qi_l[:, None] * pppm_ops.gather3(
                    grid_l, efield, xi_l, slots=slots_l)
            ek = qqr2e * ek
            f = f + qqr2e * jax.lax.all_gather(f_rows, axis, axis=0,
                                               tiled=True)[:n]
        else:
            # factored k-space over my kxy-row shard (ops/ewald_factored.py)
            from ..ops import ewald_factored as ewf
            ek_l, fk_force_l = ewf.energy_forces_fkv(
                x, q, kv_l, jnp.asarray(fk.kz), fk.unitk, ug_l)
            ek = qqr2e * jax.lax.psum(ek_l, axis)
            f = f + qqr2e * jax.lax.psum(fk_force_l, axis)

        g = ksp.g_ewald
        ek = ek - qqr2e * g / math.sqrt(math.pi) * jnp.sum(q * q)
        qsum = jnp.sum(q)
        ek = ek - qqr2e * math.pi / (2 * g * g * ksp.volume) * qsum * qsum
        pe = ev + ec + ek

        # bonded: replicated (tiny)
        from ..ops.bonded import bonded_forces
        fba, eba = bonded_forces(
            x, jnp.asarray(sys.bonds), jnp.asarray(sys.bond_coeffs),
            jnp.asarray(sys.angles), jnp.asarray(sys.angle_coeffs),
            box=box, periodic=periodic)
        f = f + fba
        pe = pe + eba

        if ksp.slabflag:
            es, fs = ewald_ops.slab_correction_energy_forces(x, q, ksp.volume)
            f = f + qqr2e * fs
            pe = pe + qqr2e * es

        if conp is not None and engine.ncfg is not None \
                and cell_grid is None and nbr is not None:
            # Gaussian correction from MY electrode rows of the Verlet list —
            # O(Ne*K/D); the multi-chip path inherits the single-chip
            # asymptotics (blist_coul_cal_post_force is one neighbor sweep,
            # fix_conp.cpp:1368-1444)
            from ..ops import neighbors as nbr_ops
            kern = conp.kernels
            f_part, e_l = nbr_ops.conp_correction_rows_from_list(
                engine.ncfg, nbr, x, q, eidx_l, evalid_l, conp.elyte_mask,
                type_idx, kern.force, kern.potential,
                cutoff=md.cutoff, qqr2e=qqr2e)
            f = f + jax.lax.psum(f_part, axis)
            pe = pe + jax.lax.psum(e_l, axis)
            qsq_ele = jnp.sum(jnp.where(elecheck != 0,
                                        jnp.asarray(kern.self_diag, x.dtype) * q * q, 0.0))
            fac = 0.5 if conp.cfg.pairmode is PairMode.ETA else 1.0
            pe = pe + qqr2e * fac * qsq_ele
        elif conp is not None:
            # Gaussian correction over MY electrode rows vs all atoms —
            # O(Ne*N/D) instead of the O(N^2/D) xor sweep; reaction forces
            # on the electrolyte come from the same tile's column sums
            # (blist_coul_cal_post_force, fix_conp.cpp:1368-1444)
            kern = conp.kernels
            xe_l = x[eidx_l]
            qe_l = q[eidx_l]
            te_l = type_idx[eidx_l]
            is_ele = elecheck != 0
            dxe = min_image(xe_l[:, None, :] - x[None, :, :],
                            jnp.asarray(box, x.dtype), periodic)
            rsq = jnp.sum(dxe * dxe, axis=-1)
            cmask = (~is_ele)[None, :] & (rsq < md.cutoff ** 2) \
                & evalid_l[:, None]
            rsq_safe = jnp.where(cmask, rsq, 1.0)
            pref = qqr2e * qe_l[:, None] * q[None, :]
            fkern = kern.force(rsq_safe, te_l[:, None], type_idx[None, :])
            ekern = kern.potential(rsq_safe, te_l[:, None], type_idx[None, :])
            forcecoul = jnp.where(cmask, pref * fkern, 0.0)
            epair = jnp.where(cmask, pref * ekern, 0.0)
            fpair = forcecoul / rsq_safe
            hp = jax.lax.Precision.HIGHEST
            f_part = -jnp.einsum("en,enc->nc", fpair, dxe, precision=hp)
            f_part = f_part.at[eidx_l].add(
                jnp.einsum("en,enc->ec", fpair, dxe, precision=hp))
            f = f + jax.lax.psum(f_part, axis)
            pe = pe + jax.lax.psum(jnp.sum(epair), axis)
            qsq_ele = jnp.sum(jnp.where(elecheck != 0,
                                        jnp.asarray(kern.self_diag, x.dtype) * q * q, 0.0))
            fac = 0.5 if conp.cfg.pairmode is PairMode.ETA else 1.0
            pe = pe + qqr2e * fac * qsq_ele

        if md.efield is not None:
            e = jnp.asarray(md.efield, x.dtype)
            f = f + u.qe2f * q[:, None] * e[None, :]
        if md.efield_feedback:
            f = f.at[:, 2].add(u.qe2f * q * (-scalar_out / box[2]))
        return f, pe

    # ------------------------------------------------------------------
    def _solve_eleallq(x, b, kv_l, ug_l, asolve_l, eidx_l, evalid_l, e0,
                       x0_cg=None):
        """Replicated b -> replicated eleallq via the configured solver.

        INV:        my A^-1 rows matvec + all_gather (fix_conp.cpp:1132-1141)
        CG:         distributed A.p — my A rows per iteration + all_gather
        CG_MATFREE: k-space applied over my k shard (psum) + my real-block
                    rows (all_gather); CG iterates replicated.  This is the
                    split module's distributed operator (km_ewald_split.cpp:
                    616-667) re-expressed as XLA collectives."""
        from ..models.conp import cg_solve
        from ..utils.config import Solver as _Solver
        cfg = conp.cfg
        hp = jax.lax.Precision.HIGHEST  # reduced-precision matmuls corrupt charges
        if cfg.solver is _Solver.INV:
            el = jnp.matmul(asolve_l, b, precision=hp)
            return jax.lax.all_gather(el, axis, axis=0, tiled=True)[:ne]
        if cfg.solver is _Solver.CG:
            def apply_a(p):
                ap_l = jnp.matmul(asolve_l, p, precision=hp)
                return jax.lax.all_gather(ap_l, axis, axis=0, tiled=True)[:ne]
            eleallq, _ = cg_solve(apply_a, b, cfg.cg_tolerance,
                                  cfg.cg_maxiter, x0=x0_cg)
            return eleallq
        # CG_MATFREE
        from ..ops import ewald_factored as ewf
        ctx = conp.ctx
        xe_all = x[jnp.asarray(ele_idx)]
        apply_phi = ewf.make_phi_operator_kv(
            xe_all, kv_l, jnp.asarray(fk.kz), fk.unitk, ug_l)
        rb_l = asolve_l
        if cfg.mobile_electrodes:
            # rebuild MY rows of the real-space block from live positions
            # (the split module rebuilds per reneighbor for mobile
            # electrodes, km_ewald_split.cpp:205-219)
            xe_l = x[eidx_l]
            te_l = type_idx[eidx_l]
            te_all = type_idx[jnp.asarray(ele_idx)]
            g = ksp.g_ewald
            dxe = min_image(xe_l[:, None, :] - xe_all[None, :, :],
                            jnp.asarray(box, x.dtype), periodic)
            rsq = jnp.sum(dxe * dxe, axis=-1)
            gid = e0 + jnp.arange(nele_row)
            rmask = (rsq < conp.cut_coulsq) & evalid_l[:, None] \
                & (gid[:, None] != jnp.arange(ne)[None, :])
            rsq_safe = jnp.where(rmask, rsq, 1.0)
            dudq = erfcr_sqrt(g * g * rsq_safe) * g + conp.kernels.potential_A(
                rsq_safe, te_l[:, None], te_all[None, :])
            rb_l = jnp.where(rmask, dudq, 0.0)
        diag_extra = ctx.diag_extra
        z_e = xe_all[:, 2]

        def apply_a(p):
            out = jax.lax.psum(apply_phi(p), axis)
            rb_rows = jnp.matmul(rb_l, p, precision=hp)
            out = out + jax.lax.all_gather(rb_rows, axis, axis=0,
                                           tiled=True)[:ne]
            out = out + diag_extra * p
            if ksp.slabflag:
                out = out + (4.0 * math.pi / ksp.volume) * z_e * jnp.sum(z_e * p)
            return out

        eleallq, _ = cg_solve(apply_a, b, cfg.cg_tolerance,
                              cfg.cg_maxiter, x0=x0_cg)
        return eleallq

    def _finish_update(x, q, step, eleallq):
        """Mode feedback (conp/conq/cond) + charge write; replicated."""
        cfg = conp.cfg
        ctx = conp.ctx
        elyte = jnp.asarray(conp.elyte_mask)
        target = cfg.target(step) if callable(cfg.target) else jnp.asarray(
            cfg.target, eleallq.dtype)
        left = (ctx.elecheck_ele == 1)
        if cfg.mode is Mode.CONP:
            potdiff = target
            scalar = potdiff * ctx.totsetq + jnp.sum(jnp.where(left, eleallq, 0.0))
        elif cfg.mode is Mode.CONQ:
            netcharge_right = -jnp.sum(jnp.where(left, eleallq, 0.0))
            scalar = -(target - netcharge_right) / ctx.totsetq
            if conp.one_electrode:
                scalar = scalar + 2.0 * target / ctx.totsetq
            potdiff = scalar
        else:
            dipole = -jnp.sum(jnp.where(elyte, q, 0.0) * x[:, 2])
            potdiff = ctx.vmult * (
                target - dipole / box[2] - jnp.sum(ctx.setzvec * eleallq))
            scalar = potdiff
        q_ele = eleallq + potdiff * ctx.elesetq + ctx.eleinitq
        q_new = q.at[jnp.asarray(ele_idx)].set(q_ele.astype(q.dtype))
        return q_new, scalar

    def sharded_elyte_kcache(x, q_elyte, tasg_l=None):
        """(rhok_elyte replicated, per-device TileSlots of MY atom rows) —
        the sharded analogue of ConpSolver.elyte_kcache.  Used by the solve
        AND by skip steps (nevery > 1) so the force path never redoes the
        electrolyte spread + forward transform.  On the tiled f32 path each
        device runs the fused z-binned spread of its rows and the partial
        rhok's psum (spread and DFT are linear)."""
        from ..ops import pppm as pppm_ops
        i0 = jax.lax.axis_index(axis) * nrow
        xi_l, qi_l = _my_rows(x, q_elyte, i0)
        if not pppm_ops._use_dense(grid_g, n):
            slots_l = _my_slots(xi_l, qi_l, tasg_l)
            if x.dtype == jnp.float32:
                rhok = jax.lax.psum(pppm_ops.spread_rhok(
                    grid_l, xi_l, qi_l, slots=slots_l), axis)
                return (rhok, slots_l)
        else:
            slots_l = None
        rho_elyte = jax.lax.psum(
            pppm_ops.spread(grid_l, xi_l, qi_l, slots=slots_l), axis)
        return (pppm_ops.rfft3(grid_g, rho_elyte), slots_l)  # rhok replicated

    def sharded_solve(x, q, step, kv_l, ug_l, asolve_l, eidx_l, evalid_l, e0,
                      nbr=None, scalar_prev=None, tasg_l=None):
        """Row/k-sharded charge solve.

        Returns replicated (q_new, scalar, kcache) — kcache is
        (rho_elyte mesh, per-device TileSlots) in PPPM mode (the force path
        reuses both: pppm_conp.cpp:428-450 invariant), None otherwise."""
        elyte = jnp.asarray(conp.elyte_mask)
        q_elyte = jnp.where(elyte, q, 0.0)
        xe_all = x[jnp.asarray(ele_idx)]
        kcache = None

        if conp.pppm_grid is not None:
            # mesh b-vector: spread MY atom rows -> psum in k-space (the
            # analogue of GridComm halo reduction,
            # pppm_conp.cpp:113-124); Poisson replicated (mesh is small;
            # XLA may shard it internally); electrode readout over MY
            # electrode rows.
            from ..ops import pppm as pppm_ops
            kcache = sharded_elyte_kcache(x, q_elyte, tasg_l)
            rhok_elyte, slots_l = kcache
            if conp.ele_zplanes is not None:
                # z-plane fast readout (models/conp.py b_vector_full)
                up = pppm_ops.u_on_zplanes(grid_g, rhok_elyte,
                                           conp.ele_zplanes)
                b_l = -pppm_ops.gather_zplanes(grid_g, up, x[eidx_l],
                                               conp.ele_zpinv)
            else:
                u_mesh = pppm_ops.poisson_u_from_k(grid_g, rhok_elyte)
                b_l = -pppm_ops.gather(grid_g, u_mesh, x[eidx_l])
            b_l = jnp.where(evalid_l, b_l, 0.0)
            b = jax.lax.all_gather(b_l, axis, axis=0, tiled=True)[:ne]
        else:
            # k-space: my kxy-shard's structure factor and electrode readout
            from ..ops import ewald_factored as ewf
            sr_l, si_l = ewf.structure_factor_fkv(
                x, q_elyte, kv_l, jnp.asarray(fk.kz), fk.unitk)
            b = -ewf.potential_on_points_fkv(
                xe_all, sr_l, si_l, kv_l, jnp.asarray(fk.kz), fk.unitk, ug_l)
            b = jax.lax.psum(b, axis)

        if engine.ncfg is not None and cell_grid is None and nbr is not None:
            # my electrode rows of the Verlet list: O(Ne*K/D) instead of a
            # dense (Ne/D, N) sweep (fix_conp.cpp:1281-1365 is one neighbor
            # sweep over the blist, never an all-atoms scan)
            from ..ops import neighbors as nbr_ops
            br_l = nbr_ops.b_realspace_rows_from_list(
                engine.ncfg, nbr, x, q_elyte, eidx_l, evalid_l,
                conp.elyte_mask, type_idx, conp.kernels.potential,
                g_ewald=ksp.g_ewald, cut_coulsq=conp.cut_coulsq)
        else:
            # real-space: my electrode rows vs all atoms
            xe_l = x[eidx_l]
            g = ksp.g_ewald
            dx = min_image(xe_l[:, None, :] - x[None, :, :],
                           jnp.asarray(box, x.dtype), periodic)
            rsq = jnp.sum(dx * dx, axis=-1)
            mask = elyte[None, :] & (rsq < conp.cut_coulsq) & evalid_l[:, None]
            rsq_safe = jnp.where(mask, rsq, 1.0)
            te_l = type_idx[eidx_l]
            dudq = erfcr_sqrt(g * g * rsq_safe) * g + conp.kernels.potential(
                rsq_safe, te_l[:, None], type_idx[None, :])
            br_l = -jnp.sum(jnp.where(mask, dudq, 0.0) * q_elyte[None, :],
                            axis=1)
        br = jax.lax.all_gather(br_l, axis, axis=0, tiled=True)[:ne]
        b = b + br

        if ksp.slabflag:
            slabcorr = (4.0 * math.pi / ksp.volume) * jnp.sum(q_elyte * x[:, 2])
            b = b - xe_all[:, 2] * slabcorr

        # CG warm start from the previous charges (replicated math —
        # identical to the single-chip engine, models/conp.py)
        x0_cg = conp._cg_warm_start(q, step, scalar_prev, b.dtype)
        eleallq = _solve_eleallq(x, b, kv_l, ug_l, asolve_l, eidx_l,
                                 evalid_l, e0, x0_cg)
        q_new, scalar = _finish_update(x, q, step, eleallq)
        return q_new, scalar, kcache

    def step_inner(state, kv_l, ug_l, exi_l, exv_l, rvalid_l, asolve_l, eidx_l, evalid_l):
        i0 = jax.lax.axis_index(axis) * nrow
        e0 = jax.lax.axis_index(axis) * nele_row
        x, v, q = state.x, state.v, state.q
        v, xi, vxi = itg.thermostat_half(v, state.nhc_xi, state.nhc_vxi, state.step)
        v = itg.kick(v, state.f)
        x_old = x
        x = itg.drift(x_old, v)
        if engine.cons is not None:
            from ..models.shake import rattle_velocities, shake_positions
            x, dv = shake_positions(engine.cons, x, x_old, itg.dt,
                                    box=box, periodic=periodic)
            v = v + dv
        if engine.zmirror is not None:
            x = engine.zmirror.apply(x, state.step + 1)

        # local (per-device) mesh-tile assignment: overflow arrives as the
        # (1,)-shaped stacked slice — unwrap to a scalar for the pppm ops
        tasg_l = None
        if mesh_persist_l and state.tasg is not None:
            tasg_l = state.tasg._replace(overflow=state.tasg.overflow[0])

        nbr = state.nbr
        if engine.ncfg is not None and cell_grid is None:
            # Verlet-skin reneighbor check; the binning sort + decode are
            # replicated (small), but the expensive candidate sweep + row
            # sort split over the CELL axis: each device selects for its
            # block of cells and the per-atom rows merge with an
            # elementwise pmin (rows a device doesn't own stay at the miss
            # sentinel; tail blocks may overlap via dynamic_slice clamping,
            # which is harmless — duplicates compute identical rows).  The
            # per-device tile assignment shares the trigger (the skin bound
            # that keeps the list exact keeps every atom inside its tile's
            # drift margin — same gate as build_engine).
            from ..ops.cells import bin_atoms
            from ..ops.neighbors import (_attach_block_list,
                                         _cell_block_keys, _decode_list,
                                         _nlist_prep, _scatter_rows,
                                         needs_rebuild)

            def rebuild_sharded(xx):
                ncfg_n = engine.ncfg
                table, cell_ids, ovf0 = bin_atoms(ncfg_n.grid, xx)
                prep = _nlist_prep(ncfg_n, xx, table, type_idx)
                c_cells = table.shape[0]
                cblk_n = -(-c_cells // d)
                c0 = jnp.minimum(jax.lax.axis_index(axis) * cblk_n,
                                 c_cells - cblk_n)
                skey, ovf_b = _cell_block_keys(ncfg_n, xx, prep, c0, cblk_n)
                sk_l = _scatter_rows(prep, skey, c0, cblk_n,
                                     n=n, k=ncfg_n.k_max)
                sk = jax.lax.pmin(sk_l, axis)
                ovf = ovf0 | (jax.lax.pmax(
                    ovf_b.astype(jnp.int32), axis) > 0)
                nl = _decode_list(ncfg_n, xx, sk, ovf, type_idx,
                                  engine.tables,
                                  build_lj=not ncfg_n.block)
                if ncfg_n.block:
                    # re-attach the block (cluster) form so the per-device
                    # block sweep keeps running after a reneighbor event
                    # (replicated two-sort compaction at rebuild cadence)
                    nl = _attach_block_list(ncfg_n, xx, nl, cell_ids,
                                            type_idx, engine.tables)
                ta = tasg_l
                if tasg_l is not None:
                    from ..ops import pppm as pppm_ops
                    xi_l, _ = _my_rows(xx, jnp.zeros((n,), xx.dtype), i0)
                    ta = pppm_ops.tile_assign(grid_l, xi_l)
                return nl, ta

            nbr, tasg_l = jax.lax.cond(
                needs_rebuild(engine.ncfg, nbr, x),
                rebuild_sharded,
                lambda xx: (nbr, tasg_l),
                x)
            # sticky overflow flag (see Engine.step): keeps the poisoning
            # cause identifiable after a post-NaN rebuild
            nbr = nbr._replace(overflow=nbr.overflow | state.nbr.overflow)

        scalar = state.scalar_out
        kcache = None
        if conp is not None:
            nevery = conp.cfg.nevery
            solve = lambda: sharded_solve(x, q, state.step + 1, kv_l, ug_l,
                                          asolve_l, eidx_l, evalid_l, e0, nbr,
                                          scalar_prev=state.scalar_out,
                                          tasg_l=tasg_l)
            if nevery == 1:
                q, scalar, kcache = solve()
            else:
                # the skip branch builds the same electrolyte mesh cache the
                # force path would otherwise redo (see Engine.step)
                def skip():
                    kc = None
                    if conp.pppm_grid is not None:
                        q_elyte = jnp.where(jnp.asarray(conp.elyte_mask),
                                            q, 0.0)
                        kc = sharded_elyte_kcache(x, q_elyte, tasg_l)
                    return q, scalar, kc
                q, scalar, kcache = jax.lax.cond(
                    (state.step + 1) % nevery == 0, solve, skip)

        f, pe = sharded_forces(x, q, scalar, kv_l, ug_l, exi_l, exv_l, rvalid_l,
                               i0, eidx_l, evalid_l, kcache, nbr,
                               tasg_l=tasg_l)
        v = itg.kick(v, f)
        if engine.cons is not None:
            from ..models.shake import rattle_velocities
            v = rattle_velocities(engine.cons, x, v, box=box, periodic=periodic)
        v, xi, vxi = itg.thermostat_half(v, xi, vxi, state.step)
        tasg_out = state.tasg
        if tasg_l is not None:
            tasg_out = tasg_l._replace(overflow=tasg_l.overflow[None])
        return MDState(x=x, v=v, q=q, f=f, step=state.step + 1, tasg=tasg_out,
                       nhc_xi=xi, nhc_vxi=vxi, scalar_out=scalar, energy=pe,
                       nbr=nbr)

    # ---- shard_map specs: the state is replicated EXCEPT the per-device
    # mesh-tile assignment, whose stacked leaves ride the device axis
    from ..ops.pppm import TileAssign as _TileAssign
    if mesh_persist_l:
        tasg_spec = _TileAssign(slot=P(axis), table=P(axis),
                                overflow=P(axis))
    else:
        tasg_spec = P()
    state_spec = MDState(
        x=P(), v=P(), q=P(), f=P(), step=P(), nhc_xi=P(), nhc_vxi=P(),
        scalar_out=P(), energy=P(), nbr=P(), tasg=tasg_spec)

    shard_step = jax.shard_map(
        step_inner, mesh=mesh,
        in_specs=(state_spec, P(axis, None), P(axis), P(axis, None),
                  P(axis, None), P(axis), P(axis, None), P(axis), P(axis)),
        out_specs=state_spec,
        check_vma=False,
    )
    step_fn = jax.jit(shard_step)

    tasg_fn = None
    tasg_table_shape = None
    if mesh_persist_l:
        from ..ops import pppm as pppm_ops

        def _build_tasg(xg):
            i0b = jax.lax.axis_index(axis) * nrow
            xi_l, _ = _my_rows(xg, jnp.zeros((n,), xg.dtype), i0b)
            a = pppm_ops.tile_assign(grid_l, xi_l)
            return a._replace(overflow=a.overflow[None])

        tasg_fn = jax.jit(jax.shard_map(
            _build_tasg, mesh=mesh, in_specs=P(), out_specs=tasg_spec,
            check_vma=False))
        geom_l = pppm_ops._tile_geometry(grid_l, nrow)
        tasg_table_shape = (d * geom_l.t_tiles, geom_l.cap)

    return ShardedEngine(engine=engine, mesh=mesh, axis=axis,
                         step_fn=step_fn, shards=shards,
                         tasg_fn=tasg_fn, tasg_table_shape=tasg_table_shape)

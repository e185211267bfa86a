"""The constant-potential / constant-charge / constant-displacement solvers.

Per-step math (reference: fix_conp.cpp:543-573 pre_force; 1120-1161
update_charge; fix_conq.cpp:41-90; fix_cond.cpp:46-126):

    b_i = -phi_i(electrolyte)        [k-space + real-space erfc + slab]
    q_ele = A^-1 b + dV * A^-1 d  (+ q_init)

with dV the applied potential (CONP), the feedback value
-(Q_R - sum_R A^-1 b)/totsetq (CONQ), or the finite-field gain
vmult*(Q_R - dipole/Lz - <zvec, A^-1 b>) (COND).

Everything here is jit-compatible: the context is a pytree of device
constants, the solve is two matmuls + elementwise updates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import ewald as ewald_ops
from ..ops.erfc import ERFC_MAX, erfcr_sqrt
from ..ops.pairs import min_image
from ..utils.config import (ConpConfig, FFMode, KSpaceStyle, MDConfig, Mode,
                            Solver)
from .electrodes import (ConpContext, ElectrodeKernels, assemble_amatrix,
                         build_d_vector, make_kernels, project_inverse)
from .system import System


@dataclasses.dataclass(frozen=True)
class ConpSolver:
    """Host wrapper holding static config + device context; the methods are
    pure functions suitable for capture inside a jitted step."""
    cfg: ConpConfig
    ksp: ewald_ops.EwaldKSpace
    kernels: ElectrodeKernels
    ctx: ConpContext
    ele_idx: np.ndarray          # (Ne,)
    elyte_mask: np.ndarray       # (N,) bool — non-electrode atoms
    type_idx: np.ndarray         # (N,)
    box: tuple
    periodic: tuple
    cut_coulsq: float            # min(coul cut^2, ERFC_MAX^2/g^2)
    qqr2e: float
    evscale: float
    ee_diag: float               # <e,e> diagnostic
    solve_dtype: object = jnp.float64
    pppm_grid: object = None     # PPPMGrid when cfg.kspace is PPPM
    fksp: object = None          # FactoredKSpace — matmul fast path for b
    one_electrode: bool = False  # group1 == group2 (fix_conp.cpp:295)
    # z-plane fast path (ops/pppm.py electrode_zplanes): the electrode
    # stencils touch only these z mesh planes, so the b-vector readout skips
    # the full inverse FFT.  None when electrodes are mobile.
    ele_zplanes: object = None   # (P,) np.int32 or None
    ele_zpinv: object = None     # (nz,) np.int32, -1 outside the set

    @property
    def ne(self) -> int:
        return len(self.ele_idx)

    @property
    def ele_contig(self) -> bool:
        """True when the electrodes occupy rows [0, Ne) — the layout
        models.system.electrodes_first produces.  Every per-step electrode
        gather/scatter then lowers as a static slice (free under XLA
        fusion) instead of a gather; the helpers below pick the path at
        trace time."""
        e = np.asarray(self.ele_idx)
        return len(e) > 0 and int(e[0]) == 0 and int(e[-1]) == len(e) - 1

    def _ele_rows(self, arr):
        """arr[ele_idx] as a static slice when the layout allows."""
        if self.ele_contig:
            return arr[:self.ne]
        return arr[jnp.asarray(self.ele_idx)]

    def _set_ele(self, q, vals):
        """q with the electrode rows replaced (slice-concat when contiguous
        — a scatter otherwise)."""
        if self.ele_contig:
            return jnp.concatenate([vals.astype(q.dtype), q[self.ne:]])
        return q.at[jnp.asarray(self.ele_idx)].set(vals.astype(q.dtype))

    # ----------------------------------------------------------------- b
    def b_vector(self, x, q):
        b, _ = self.b_vector_full(x, q)
        return b

    def elyte_kcache(self, x, q, tasg=None):
        """(rhok_elyte, slots) exactly as b_vector_full builds them.

        Also called by engine steps that SKIP the charge solve (nevery > 1)
        so the force path's mesh-reuse invariant (pppm_conp.cpp:428-450)
        holds on EVERY step, not just solve steps — and so both lax.cond
        branches return an identically-shaped cache.

        In factored-Ewald mode the cache is (axis_tables, Sr_elyte,
        Si_elyte) — the per-step transcendental tables plus the
        electrolyte structure factor, shared with the force path the same
        way."""
        if self.pppm_grid is None:
            if self._ewald_cacheable():
                from ..ops import ewald_factored as ewf
                dt = self.solve_dtype
                x = x.astype(dt)
                q = q.astype(dt)
                q_elyte = jnp.where(jnp.asarray(self.elyte_mask), q, 0.0)
                tabs = ewf.axis_tables(self.fksp, x)
                sr, si = ewf.structure_factor_tab(tabs, q_elyte)
                return (tabs, sr, si)
            return None
        from ..ops import pppm as pppm_ops
        dt = self.solve_dtype
        x = x.astype(dt)
        q = q.astype(dt)
        q_elyte = jnp.where(jnp.asarray(self.elyte_mask), q, 0.0)
        grid = self.pppm_grid
        slots = None
        if tasg is not None:
            slots = pppm_ops.refresh_tile_slots(grid, tasg, x, q_elyte)
        elif not pppm_ops._use_dense(grid, x.shape[0]):
            slots = pppm_ops.tile_slots(grid, x, q_elyte)
        rhok_elyte = pppm_ops.spread_rhok(grid, x, q_elyte, slots=slots)
        return (rhok_elyte, slots)

    def _ewald_cacheable(self) -> bool:
        """Whether the factored-Ewald per-step table cache applies: above
        KXY_CHUNK the full tables are deliberately never materialized
        (chunked scan), so there is nothing to share."""
        from ..ops import ewald_factored as ewf
        return (self.fksp is not None
                and self.fksp.nxy <= ewf.KXY_CHUNK)

    def b_vector_full(self, x, q, nbr=None, ncfg=None, tasg=None):
        """Assemble b for the current electrolyte configuration.

        k-space: b_i -= sum_k 2 ug_k (c_i ReS + s_i ImS)   [km_ewald.cpp:789-825]
        real:    b_i -= sum_(elyte j in range) q_j (erfc(g r)/r + pot(r))
                                                            [fix_conp.cpp:1281-1365]
        slab:    b_i -= z_i * (4 pi / V) sum_elyte q_j z_j  [km_ewald.cpp:827-847]

        ``tasg``: a persistent pppm TileAssign — the mesh binning is then a
        cheap per-step refresh instead of a sort (the sort amortizes over
        the reneighbor interval, like the Verlet list)."""
        dt = self.solve_dtype
        x = x.astype(dt)
        q = q.astype(dt)
        xe = self._ele_rows(x)
        elyte = jnp.asarray(self.elyte_mask)
        q_elyte = jnp.where(elyte, q, 0.0)

        kcache = None
        if self.pppm_grid is not None:
            # mesh path (PPPMCONP::b_cal, pppm_conp.cpp:269-316): spread the
            # electrolyte, Poisson-solve, stencil-gather at the electrodes.
            # (rhok_elyte, slots) are returned for the force-path reuse
            # invariant (SURVEY.md section 3.4): the force path adds the
            # electrode density IN K-SPACE (by linearity) and the gather
            # runs at the same positions, so both the electrolyte forward
            # FFT and the tile binning are paid once per step.
            from ..ops import pppm as pppm_ops
            grid = self.pppm_grid
            kcache = self.elyte_kcache(x, q, tasg)
            rhok_elyte, slots = kcache
            if self.ele_zplanes is not None:
                # electrodes live on a handful of z planes: read u there
                # via a small z-DFT matmul + P tiny 2-D FFTs instead of a
                # full inverse FFT (ops/pppm.py u_on_zplanes)
                up = pppm_ops.u_on_zplanes(grid, rhok_elyte,
                                           self.ele_zplanes)
                b = -pppm_ops.gather_zplanes(grid, up, xe, self.ele_zpinv)
            else:
                u = pppm_ops.poisson_u_from_k(grid, rhok_elyte)
                b = -pppm_ops.gather(grid, u, xe)
        elif self.fksp is not None:
            # factorized-Ewald fast path: 8 matmuls instead of O(N*K)
            # transcendentals (ops/ewald_factored.py)
            from ..ops import ewald_factored as ewf
            if self._ewald_cacheable():
                # build the per-step tables ONCE for all atoms; the
                # electrode readout slices rows, and (tabs, S_elyte) are
                # returned for the force-path reuse invariant
                kcache = self.elyte_kcache(x, q)
                tabs, sr, si = kcache
                (pr, pi), (zr, zi) = tabs
                tabs_e = ((self._ele_rows(pr), self._ele_rows(pi)),
                          (self._ele_rows(zr), self._ele_rows(zi)))
                b = -ewf.potential_on_points_tab(tabs_e, sr, si,
                                                 self.fksp.ug)
            else:
                sr, si = ewf.structure_factor_f(self.fksp, x, q_elyte)
                b = -ewf.potential_on_points_f(self.fksp, xe, sr, si)
        else:
            kvecs = jnp.asarray(self.ksp.kvecs, dt)
            ug = jnp.asarray(self.ksp.ug, dt)
            sre, sim = ewald_ops.structure_factor(x, q_elyte, kvecs)
            b = -ewald_ops.kspace_potential_on_points(xe, kvecs, ug, sre, sim)

        # real-space rows over (Ne x N)
        g = self.ksp.g_ewald
        te = self.type_idx[self.ele_idx]
        if nbr is not None and ncfg is not None:
            # electrode rows of the Verlet list: O(Ne*K) instead of O(Ne*N)
            from ..ops.neighbors import b_realspace_from_list
            b = b + b_realspace_from_list(
                ncfg, nbr, x, q_elyte, jnp.asarray(self.ele_idx),
                self.elyte_mask, jnp.asarray(self.type_idx),
                self.kernels.potential, g_ewald=g,
                cut_coulsq=self.cut_coulsq)
        else:
            dx = min_image(xe[:, None, :] - x[None, :, :],
                           jnp.asarray(self.box, dt), self.periodic)
            rsq = jnp.sum(dx * dx, axis=-1)
            mask = elyte[None, :] & (rsq < self.cut_coulsq)
            rsq_safe = jnp.where(mask, rsq, 1.0)
            dudq = erfcr_sqrt(g * g * rsq_safe) * g + self.kernels.potential(
                rsq_safe, jnp.asarray(te)[:, None],
                jnp.asarray(self.type_idx)[None, :])
            b = b - jnp.sum(jnp.where(mask, dudq, 0.0) * q_elyte[None, :],
                            axis=1)

        if self.ksp.slabflag:
            slabcorr = (4.0 * math.pi / self.ksp.volume) * jnp.sum(
                q_elyte * x[:, 2])
            b = b - xe[:, 2] * slabcorr
        return b, kcache

    # ------------------------------------------------------------- solve
    def solve(self, x, q, step):
        q_new, scalar, _ = self.solve_full(x, q, step)
        return q_new, scalar

    def solve_full(self, x, q, step, nbr=None, ncfg=None, scalar_prev=None,
                   tasg=None):
        """One charge update. Returns (q_new, scalar_output, kcache).

        scalar: CONP induced charge dV*totsetq + sum_left(A^-1 b)
        (fix_conp.cpp:1159); CONQ required potential (fix_conq.cpp:78);
        COND dV (fix_cond.cpp:115).  kcache is (rhok_elyte, tile_slots) in
        PPPM mode (None otherwise) — the cached electrolyte density mesh
        and tile binning for force-path reuse.  ``nbr``/``ncfg``: the
        engine's Verlet list, reused for the b real-space rows.
        ``scalar_prev``: the previous step's fix scalar — lets the CG
        solvers warm-start from the previous electrode charges (one MD step
        barely moves them, so CG converges in a fraction of the cold-start
        iterations)."""
        ctx = self.ctx
        cfg = self.cfg
        b, kcache = self.b_vector_full(x, q, nbr, ncfg, tasg)
        x0_cg = self._cg_warm_start(q, step, scalar_prev, b.dtype)
        if cfg.solver is Solver.CG:
            eleallq, _ = cg_solve(ctx.amat, b, cfg.cg_tolerance,
                                  cfg.cg_maxiter, x0=x0_cg)
        elif cfg.solver is Solver.CG_MATFREE:
            xe = x.astype(self.solve_dtype)[self.ele_idx]
            real_block = ctx.real_block
            if cfg.mobile_electrodes:
                # true mobile-electrode support (beyond the reference, whose
                # A is frozen at setup): rebuild the real-space block and let
                # the k-space operator use live positions
                te = jnp.asarray(self.type_idx[self.ele_idx])
                real_block = _realspace_block(
                    xe, te, self.kernels, g=self.ksp.g_ewald, box=self.box,
                    periodic=self.periodic, cut_coulsq=self.cut_coulsq,
                    dtype=self.solve_dtype)
            apply_a = make_matfree_operator(
                self.fksp, xe, real_block, ctx.diag_extra,
                slabflag=self.ksp.slabflag, volume=self.ksp.volume)
            eleallq, _ = cg_solve(apply_a, b, cfg.cg_tolerance,
                                  cfg.cg_maxiter, x0=x0_cg)
        else:
            eleallq = jnp.matmul(ctx.ainv, b,
                                 precision=jax.lax.Precision.HIGHEST)

        target = cfg.target(step) if callable(cfg.target) else jnp.asarray(
            cfg.target, b.dtype)

        left = (ctx.elecheck_ele == 1)
        if cfg.mode is Mode.CONP:
            potdiff = target
            scalar = potdiff * ctx.totsetq + jnp.sum(jnp.where(left, eleallq, 0.0))
        elif cfg.mode is Mode.CONQ:
            netcharge_right = -jnp.sum(jnp.where(left, eleallq, 0.0))
            scalar = -(target - netcharge_right) / ctx.totsetq
            if self.one_electrode:
                scalar = scalar + 2.0 * target / ctx.totsetq  # fix_conq.cpp:79
            potdiff = scalar
        else:  # COND
            elyte = jnp.asarray(self.elyte_mask)
            lz = self.box[2]
            dipole = -jnp.sum(jnp.where(elyte, q, 0.0) * x[:, 2])
            potdiff = ctx.vmult * (
                target - dipole / lz - jnp.sum(ctx.setzvec * eleallq))
            scalar = potdiff

        q_ele = eleallq + potdiff * ctx.elesetq + ctx.eleinitq
        q_new = self._set_ele(q, q_ele)
        return q_new, scalar, kcache

    def _cg_warm_start(self, q, step, scalar_prev, dt):
        """Reconstruct the previous step's A^-1 b iterate from the current
        electrode charges: eleallq_prev = q_ele - potdiff_prev*elesetq -
        eleinitq (inverting the update rule of solve_full).  potdiff is the
        target itself for CONP; for CONQ/COND it equals the previous fix
        scalar — skipped when unknown.  The result is de-meaned so CG stays
        on the charge-neutral subspace regardless of the input."""
        cfg = self.cfg
        if cfg.solver is Solver.INV:
            return None
        if cfg.mode is Mode.CONP:
            # the charges q were written by the PREVIOUS solve, which used
            # target(step - nevery) — a ramped (callable) target evaluated
            # at the current step would skew the reconstruction by
            # (dtarget)*elesetq and cost the warm start iterations
            potdiff_prev = (cfg.target(step - cfg.nevery)
                            if callable(cfg.target)
                            else jnp.asarray(cfg.target, dt))
        elif scalar_prev is not None:
            potdiff_prev = jnp.asarray(scalar_prev, dt)
        else:
            return None
        ctx = self.ctx
        x0 = (self._ele_rows(q.astype(dt)) - ctx.eleinitq
              - potdiff_prev * ctx.elesetq)
        x0 = x0 - jnp.mean(x0)
        # overflow recovery heals from NaN-poisoned charges (md.py
        # _heal_state) — fall back to a cold start rather than seeding CG
        # with NaN
        return jnp.where(jnp.all(jnp.isfinite(x0)), x0, 0.0)

    def cg_iterations(self, x, q, nbr=None, ncfg=None) -> int:
        """CG iteration count for the current configuration — the per-solve
        trace the reference flushes to its timing log (fix_conp.cpp:926-928).
        Returns 0 for the direct INV solver."""
        cfg = self.cfg
        if cfg.solver is Solver.INV:
            return 0

        @jax.jit
        def count(x, q):
            xx = x.astype(self.solve_dtype)
            qq = q.astype(self.solve_dtype)
            b, _ = self.b_vector_full(xx, qq, nbr, ncfg)
            if cfg.solver is Solver.CG:
                _, it = cg_solve(self.ctx.amat, b, cfg.cg_tolerance,
                                 cfg.cg_maxiter)
            else:
                xe = xx[self.ele_idx]
                apply_a = make_matfree_operator(
                    self.fksp, xe, self.ctx.real_block, self.ctx.diag_extra,
                    slabflag=self.ksp.slabflag, volume=self.ksp.volume)
                _, it = cg_solve(apply_a, b, cfg.cg_tolerance, cfg.cg_maxiter)
            return it

        return int(count(jnp.asarray(x), jnp.asarray(q)))


def cg_solve(amat, b, tol: float, maxiter: int, x0=None):
    """Neutrality-projected conjugate gradient (FixConp::cg,
    fix_conp.cpp:864-930): residuals and search directions are de-meaned
    every iteration to stay on the charge-neutral subspace; convergence when
    <r, p>/Ne < tol.  jit-compatible lax.while_loop.

    ``amat`` may be an (Ne, Ne) matrix or a callable p -> A @ p
    (the matrix-free production-scale path).  ``x0``: optional warm-start
    iterate (the previous step's solution) — costs one extra A apply for
    the initial residual, saves many iterations."""
    ne = b.shape[0]
    apply_a = amat if callable(amat) else (
        lambda p: jnp.matmul(amat, p, precision=jax.lax.Precision.HIGHEST))

    def demeaned(res):
        netr = jnp.sum(res)
        return res - netr / ne, jnp.sum(res * res) - netr * (netr / ne)

    if x0 is None:
        x0 = jnp.zeros_like(b)
        res0 = b
    else:
        res0 = b - apply_a(x0)
    p0, lresnorm0 = demeaned(res0)
    # note: reference keeps res un-demeaned; p = res - avenetr

    def cond(carry):
        it, x, res, p, lresnorm, lgamma = carry
        return (lresnorm / ne >= tol) & (it < maxiter)

    def body(carry):
        it, x, res, p, lresnorm, lgamma = carry
        ap = apply_a(p)
        alpha = lresnorm / jnp.sum(p * ap)
        x = x + alpha * p
        res = res - alpha * ap
        dm, lgamma_new = demeaned(res)
        beta = lgamma_new / lgamma
        p = beta * p + dm
        lresnorm = jnp.sum(res * p)
        return it + 1, x, res, p, lresnorm, lgamma_new

    it, x, res, p, lresnorm, _ = jax.lax.while_loop(
        cond, body, (jnp.zeros((), jnp.int32), x0, res0, p0, lresnorm0,
                     lresnorm0))
    return x, it


def make_matfree_operator(fksp, xe, real_block, diag_extra, *, slabflag,
                          volume):
    """A.p as a function: k-space via factored Ewald on the electrode set
    (the on-the-fly S_p includes the ug_tot diagonal), plus the cached
    real-space erfc block, the non-kspace diagonal (-2g/sqrt(pi) + self), and
    the slab rank-1 term (4pi/V) z z^T.

    Nothing O(Ne^2) in k-space is ever formed; cost per apply is
    O(Ne*(nxy+nz)) trig + O(Ne*nxy*nz) matmul flops.  The electrode phase
    tables are hoisted out of the apply so CG iterations reuse them."""
    from ..ops import ewald_factored as ewf
    z = xe[:, 2]
    apply_phi = ewf.make_phi_operator_kv(xe, fksp.kxy, fksp.kz, fksp.unitk,
                                         fksp.ug)

    def apply_a(p):
        out = apply_phi(p)
        out = out + jnp.matmul(real_block, p,
                               precision=jax.lax.Precision.HIGHEST)
        out = out + diag_extra * p
        if slabflag:
            out = out + (4.0 * math.pi / volume) * z * jnp.sum(z * p)
        return out

    return apply_a


def _realspace_block(xe, type_e, kernels, *, g, box, periodic, cut_coulsq,
                     dtype):
    """The (Ne, Ne) real-space erfc + Gaussian block of A (off-diagonal)."""
    ne = xe.shape[0]
    dx = min_image(xe[:, None, :] - xe[None, :, :], jnp.asarray(box, dtype),
                   periodic)
    rsq = jnp.sum(dx * dx, axis=-1)
    mask = (rsq < cut_coulsq) & (~jnp.eye(ne, dtype=bool))
    rsq_safe = jnp.where(mask, rsq, 1.0)
    dudq = erfcr_sqrt(g * g * rsq_safe) * g + kernels.potential_A(
        rsq_safe, type_e[:, None], type_e[None, :])
    return jnp.where(mask, dudq, 0.0)


def setup_conp(
    system: System,
    md: MDConfig,
    cfg: ConpConfig,
    *,
    x0: Optional[np.ndarray] = None,
    q0: Optional[np.ndarray] = None,
    g_ewald: Optional[float] = None,
    solve_dtype=jnp.float64,
) -> ConpSolver:
    """One-time setup: k-space tables, A assembly, inverse + projection,
    d vector, elesetq, cond gain.  Mirrors linalg_init/linalg_setup
    (fix_conp.cpp:393-464).

    The setup linear algebra always runs on the host CPU in float64 (the
    per-step path may run in float32; the one-time inverse must not lose
    precision), then the context is cast to ``solve_dtype``.
    """
    cpu = jax.local_devices(backend="cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        solver64 = _setup_conp_f64(system, md, cfg, x0=x0, q0=q0, g_ewald=g_ewald)
    if solve_dtype == jnp.float64:
        return solver64
    # cast the per-step context to the run dtype
    ctx = jax.tree.map(
        lambda a: (jnp.asarray(np.asarray(a), solve_dtype)
                   if jnp.asarray(a).dtype in (jnp.float64, jnp.float32)
                   else jnp.asarray(np.asarray(a))),
        solver64.ctx)
    return dataclasses.replace(solver64, ctx=ctx, solve_dtype=solve_dtype)


def _setup_conp_f64(
    system: System,
    md: MDConfig,
    cfg: ConpConfig,
    *,
    x0: Optional[np.ndarray] = None,
    q0: Optional[np.ndarray] = None,
    g_ewald: Optional[float] = None,
    solve_dtype=jnp.float64,
) -> ConpSolver:
    units = system.units()
    x0 = system.x0 if x0 is None else np.asarray(x0)
    q0 = system.q0 if q0 is None else np.asarray(q0)
    ele_idx = np.nonzero(system.ele_mask)[0]
    if len(ele_idx) == 0:
        raise ValueError("no electrode atoms")
    one_electrode = not system.ele_right_mask.any()

    # --- k-space setup (accuracy from the host kspace style, km_ewald.cpp:63-132)
    natoms = system.natoms
    qsqsum = float((q0 ** 2).sum())
    q2 = qsqsum * units.qqr2e
    acc_abs = md.kspace_accuracy * units.qqr2e  # two-charge force = qqr2e/1A^2
    box = system.box
    slabflag = (md.slab is not None) and (cfg.ff is FFMode.NORMAL)
    slab_volfactor = md.slab if slabflag else 1.0
    if g_ewald is None:
        g_ewald = md.g_ewald
    pppm_grid = None
    if g_ewald is None:
        # all reference decks use a pppm host kspace style; the fix takes
        # g_ewald from it (km_ewald.cpp:66) — reproduce the LAMMPS pppm
        # pipeline exactly (validated vs persist.log: g=0.77236341)
        from ..ops import pppm as pppm_ops
        g_ewald, _, _ = pppm_ops.set_grid_and_gewald(
            box=box, accuracy_abs=acc_abs, natoms=natoms, q2=max(q2, 1e-10),
            cutoff=md.cutoff,
            slab_volfactor=md.slab if md.slab is not None else 1.0)
    ksp = ewald_ops.setup_ewald(
        box=box, accuracy_abs=acc_abs, g_ewald=g_ewald, natoms=natoms,
        q2=max(q2, 1e-10), slabflag=slabflag, slab_volfactor=slab_volfactor)
    if cfg.kspace is KSpaceStyle.PPPM:
        from ..ops import pppm as pppm_ops
        pppm_grid = pppm_ops.setup_pppm(
            box=box, box_lo=tuple(system.box_lo), accuracy_abs=acc_abs,
            natoms=natoms, q2=max(q2, 1e-10), cutoff=md.cutoff,
            slabflag=slabflag,
            slab_volfactor=slab_volfactor if slabflag else 1.0,
            g_ewald=g_ewald)
        # occupancy-measured tile slot capacity (cap multiplies every tile
        # matmul's flops; the density formula over-sizes ~2.7x at 100k)
        pppm_grid = pppm_ops.with_tile_cap(pppm_grid, x0)

    kernels = make_kernels(cfg, system)
    cut_coulsq = min(md.cutoff ** 2, (ERFC_MAX / g_ewald) ** 2)

    xe = jnp.asarray(x0[ele_idx], solve_dtype)
    type_e = jnp.asarray(system.type[ele_idx])

    # --- A matrix, inverse, projection
    use_cg = cfg.solver is Solver.CG
    matfree = cfg.solver is Solver.CG_MATFREE
    amat = jnp.zeros((1, 1), solve_dtype)
    real_block = jnp.zeros((1, 1), solve_dtype)
    diag_extra = jnp.zeros((1,), solve_dtype)
    from ..ops.ewald_factored import factorize
    # the factored tables also back the CG_MATFREE electrode operator in PPPM
    # mode: exact-Ewald A + mesh b is the reference's own architecture
    # (pppm_conp.cpp:91-101 builds a KSpaceModuleEwald just for a_cal)
    fksp = (factorize(ksp)
            if (cfg.kspace is not KSpaceStyle.PPPM or matfree) else None)
    if matfree:
        # production-scale path: never assemble the k-space block
        real_block = _realspace_block(
            xe, type_e, kernels, g=g_ewald, box=box,
            periodic=system.periodic, cut_coulsq=cut_coulsq,
            dtype=solve_dtype)
        diag_extra = jnp.asarray(
            kernels.self_diag[ele_idx] - 2.0 / math.sqrt(math.pi) * g_ewald,
            solve_dtype)
        apply_a = make_matfree_operator(
            fksp, xe, real_block, diag_extra,
            slabflag=ksp.slabflag, volume=ksp.volume)
        ainv = jnp.zeros((1, 1), solve_dtype)
        ee = float("nan")
    elif cfg.ainv_file is not None:
        from ..utils import matio
        ainv = jnp.asarray(
            matio.read_matrix(cfg.ainv_file, system.tag[ele_idx])[1], solve_dtype)
        ee = float("nan")
    else:
        if cfg.a_file is not None:
            from ..utils import matio
            a = jnp.asarray(
                matio.read_matrix(cfg.a_file, system.tag[ele_idx])[1], solve_dtype)
        else:
            a = assemble_amatrix(
                xe, type_e, kernels.self_diag[ele_idx], ksp, kernels,
                box=box, periodic=system.periodic, cut_coulsq=cut_coulsq,
                dtype=solve_dtype)
        if cfg.matout:
            from ..utils import matio
            matio.write_matrix("amatrix", system.tag[ele_idx], np.asarray(a))
        if use_cg:
            # CG skips the O(Ne^3) inverse entirely (fix_conp.cpp:864-930);
            # neutrality is kept by de-meaned residuals, not projection
            amat = a
            ainv = jnp.zeros((1, 1), solve_dtype)
            ee = float("nan")
        else:
            ainv = jnp.linalg.inv(a)
            zhalf = system.box_lo[2] + box[2] / 2
            if not one_electrode:
                ainv, ee = project_inverse(
                    ainv, nullneutral=not cfg.nonneutral, zneutr=cfg.zneutr,
                    z_e=xe[:, 2], zhalf=zhalf)
                ee = float(ee)
            else:
                ee = float(jnp.sum(ainv))

    # --- d vector and elesetq (b_setq_cal + get_setq)
    d = build_d_vector(system, cfg, x0[ele_idx])
    d_j = jnp.asarray(d, solve_dtype)
    if matfree:
        elesetq, _ = cg_solve(apply_a, d_j, cfg.cg_tolerance, cfg.cg_maxiter)
    elif use_cg:
        elesetq, _ = cg_solve(amat, d_j, cfg.cg_tolerance, cfg.cg_maxiter)
    else:
        elesetq = ainv @ d_j
    elecheck_ele = jnp.asarray(system.elecheck[ele_idx])
    totsetq = jnp.sum(jnp.where(elecheck_ele == 1, elesetq, 0.0))

    if one_electrode and not use_cg:
        # projection deferred until after setq (fix_conp.cpp:958, 1115)
        zhalf = system.box_lo[2] + box[2] / 2
        ainv, ee = project_inverse(
            ainv, nullneutral=not cfg.nonneutral, zneutr=cfg.zneutr,
            z_e=xe[:, 2], zhalf=zhalf)
        ee = float(ee)

    if cfg.matout and cfg.ainv_file is None and not use_cg:
        from ..utils import matio
        matio.write_matrix("inv_a_matrix", system.tag[ele_idx], np.asarray(ainv))

    eleinitq = (jnp.asarray(q0[ele_idx], solve_dtype) if cfg.qinit
                else jnp.zeros(len(ele_idx), solve_dtype))

    # --- cond feedback gain (fix_cond.cpp:46-68)
    if cfg.mode is Mode.COND:
        if cfg.ff is not FFMode.FFIELD:
            raise ValueError("cond requires ffield mode")
        setzvec = d_j / units.evscale
        zOAz = jnp.sum(elesetq * setzvec)
        lz = box[2]
        axy = box[0] * box[1]
        vmult = 4.0 * math.pi * zOAz * lz / (units.evscale * axy)
        vmult = vmult / (1.0 + vmult)
        vmult = vmult / zOAz
    else:
        setzvec = jnp.zeros(len(ele_idx), solve_dtype)
        vmult = jnp.zeros((), solve_dtype)

    ctx = ConpContext(
        ainv=ainv, amat=amat, real_block=real_block, diag_extra=diag_extra,
        d=d_j, elesetq=elesetq, totsetq=totsetq,
        eleinitq=eleinitq, elecheck_ele=elecheck_ele,
        ele_idx=jnp.asarray(ele_idx), setzvec=setzvec,
        vmult=jnp.asarray(vmult, solve_dtype),
    )

    ele_zplanes = ele_zpinv = None
    if pppm_grid is not None and not cfg.mobile_electrodes:
        from ..ops import pppm as pppm_ops
        zp = pppm_ops.electrode_zplanes(pppm_grid, x0[ele_idx])
        # the z-plane transform does P plane FFTs + a (nzh, P) z-DFT; for a
        # z-extended (rough) electrode occupying a large fraction of the
        # mesh the full inverse FFT is cheaper — gate on the plane count
        if len(zp) <= max(pppm_grid.nz // 4, 16):
            ele_zplanes = zp
            ele_zpinv = pppm_ops.zplane_inverse(pppm_grid, ele_zplanes)

    return ConpSolver(
        cfg=cfg, ksp=ksp, kernels=kernels, ctx=ctx, fksp=fksp,
        ele_idx=ele_idx, elyte_mask=~system.ele_mask,
        type_idx=system.type, box=box, periodic=system.periodic,
        cut_coulsq=cut_coulsq, qqr2e=units.qqr2e, evscale=units.evscale,
        ee_diag=ee, solve_dtype=solve_dtype, pppm_grid=pppm_grid,
        one_electrode=one_electrode,
        ele_zplanes=ele_zplanes, ele_zpinv=ele_zpinv,
    )

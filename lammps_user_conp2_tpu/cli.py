"""Command-line deck runner: `python -m lammps_user_conp2_tpu ...`.

Replaces the reference's `N=0 lmp -i input` workflow (SURVEY.md section 4):

  run       — run a named workload trial, print LAMMPS-style thermo, write a
              log (and optionally a trajectory dump / checkpoint)
  rerun     — recompute electrode charges from a dumped trajectory
  compare   — overlay charge columns of two or more logs (the compare.gnu
              equivalent, numeric instead of gnuplot)
  profile   — per-phase timing breakdown on the current backend
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .utils.config import PAIR_PATHS


def _build(args):
    import jax
    if not args.f32:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from . import workloads
    from .models.conp import setup_conp
    from .models.md import build_engine

    system, md, cfg = getattr(workloads, args.workload)(args.trial)
    if getattr(args, "solver", None):
        import dataclasses
        from .utils.config import Solver
        cfg = dataclasses.replace(cfg, solver=Solver(args.solver))
    if getattr(args, "pair_path", None):
        import dataclasses
        md = dataclasses.replace(md, pair_path=args.pair_path)
    if getattr(args, "kmax", None):
        import dataclasses
        md = dataclasses.replace(md, neighbor_kmax=args.kmax)
    dtype = jnp.float32 if args.f32 else jnp.float64
    solver = setup_conp(system, md, cfg, solve_dtype=dtype)
    eng = build_engine(system, md, solver, dtype=dtype)
    return system, eng


def cmd_run(args):
    import jax
    system, eng = _build(args)
    st = jax.block_until_ready(jax.jit(eng.init_state)())
    cols = ["step", "temp", "tempsl", "qleft", "qright", "dipole", "f_e", "pe"]
    out = open(args.log, "w") if args.log else sys.stdout
    # column-for-column the reference's thermo_style custom
    # (tests/cond/input:74), plus PotEng
    print("Step Temp c_tempsl c_qleft c_qright c_dipole f_e PotEng", file=out)
    th0 = {k: float(v) for k, v in eng.thermo(st).items()}
    print(" ".join(f"{th0[c]:.8g}" for c in cols), file=out)
    dumpf = open(args.dump, "w") if args.dump else None
    nchunk = args.thermo
    if dumpf is None:
        # chain the ENTIRE run as one device program — thermo accumulates
        # on-device, one host fetch at the end (no per-chunk host sync).
        eng.compile_run(st, args.steps, thermo_every=nchunk)
        t0 = time.time()
        st, th = eng.run(st, args.steps, thermo_every=nchunk)
        jax.block_until_ready(st.x)
        wall = time.time() - t0
        th = {k: np.asarray(v) for k, v in th.items()}
        for i in range(len(th["step"])):
            print(" ".join(f"{float(th[c][i]):.8g}" for c in cols), file=out)
        if nchunk > 0 and args.steps % nchunk != 0:
            # the chained thermo slice only carries multiples of the
            # interval — emit the final state's row too (the reference log
            # always ends on the run's last step)
            thf = {k: float(v) for k, v in eng.thermo(st).items()}
            print(" ".join(f"{thf[c]:.8g}" for c in cols), file=out)
    else:
        # trajectory dumps need per-chunk host fetches
        _ = jax.block_until_ready(eng.run(st, nchunk, thermo_every=nchunk)[0])
        t0 = time.time()
        for start in range(0, args.steps, nchunk):
            n = min(nchunk, args.steps - start)
            st, th = eng.run(st, n, thermo_every=n)
            row = {k: float(np.asarray(v)[-1]) for k, v in th.items()}
            print(" ".join(f"{row[c]:.8g}" for c in cols), file=out, flush=True)
            from .utils import dump as dumpio
            dumpio.write_dump_frame(dumpf, int(row["step"]), system.natoms,
                                    system.box_lo, system.box_hi, system.tag,
                                    np.asarray(st.x), np.asarray(st.q))
        wall = time.time() - t0
    print(f"# Loop time {wall:.3f} s for {args.steps} steps "
          f"({args.steps / wall:.3f} steps/s)", file=out)
    if args.log and not args.no_timing:
        # per-run timing flush — the analogue of the reference's
        # Btime/Ctime/Ktime + CG-iteration log lines at run end
        # (fix_conp.cpp:553-567, 926-928)
        from .utils.timers import profile_step
        prof = profile_step(eng, st, iters=3)
        for k, v in prof.items():
            print(f"# {k}: {v * 1e3:.3f} ms", file=out)
        if eng.conp is not None:
            it = eng.conp.cg_iterations(st.x, st.q, st.nbr, eng.ncfg)
            if it:
                print(f"# cg_iterations: {it}", file=out)
    if args.checkpoint:
        from .utils.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, eng, st)
    if out is not sys.stdout:
        out.close()
        print(f"wrote {args.log}; {args.steps / wall:.2f} steps/s")


def cmd_rerun(args):
    system, eng = _build(args)
    from .utils import dump as dumpio
    frames = dumpio.read_dump(args.traj)
    out = dumpio.rerun_charges(eng.conp, frames, system.q0, tags=system.tag)
    print("Step c_qleft c_qright f_e")
    for (step, tags, cols), (_, qn, fe) in zip(frames, out):
        ql = qn[system.ele_left_mask].sum()
        qr = qn[system.ele_right_mask].sum()
        print(f"{step} {ql:.8g} {qr:.8g} {fe:.8g}")


def cmd_compare(args):
    from .utils.lammps_log import parse_thermo_blocks
    series = []
    for path in args.logs:
        blocks = parse_thermo_blocks(path)
        if not blocks:
            print(f"{path}: no thermo block found")
            return 1
        series.append((path, blocks[-1]))
    col = args.column
    base = series[0][1][col]
    print(f"column {col}, {len(base)} rows; reference = {series[0][0]}")
    for path, blk in series[1:]:
        n = min(len(base), len(blk[col]))
        diff = np.abs(blk[col][:n] - base[:n])
        print(f"{path}: max|diff|={diff.max():.3e} rms={np.sqrt((diff**2).mean()):.3e}")
    return 0


SUITE_TRIALS = {
    # cross-comparable trials per deck (same physics, different modes) and
    # the charge column used by the reference's compare.gnu overlays
    "dilute": ([0, 1, 2], "c_qleft"),
    "il_onelayer": ([0, 1, 3], "c_qleft"),
    "il_twolayer": ([0, 1, 2], "c_qleft"),
}


def cmd_run_suite(args):
    """Run a deck's equivalent-mode trials and report their agreement —
    the whole reference validation workflow (env-var runs + compare.gnu)
    in one command."""
    trials, col = SUITE_TRIALS[args.workload]
    logs = []
    for n in trials:
        log = f"log.{args.workload}_{n}"
        a = argparse.Namespace(**vars(args))
        a.trial = n
        a.log = log
        a.dump = None
        a.checkpoint = None
        a.no_timing = True
        cmd_run(a)
        logs.append(log)
    a = argparse.Namespace(logs=logs, column=col)
    return cmd_compare(a)


def cmd_profile(args):
    system, eng = _build(args)
    from .utils.timers import profile_step
    st = eng.init_state()
    res = profile_step(eng, st, iters=args.iters)
    print(json.dumps({k: f"{v * 1e3:.3f} ms" for k, v in res.items()}, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lammps_user_conp2_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_common(p):
        p.add_argument("workload", help="dilute | il_onelayer | il_twolayer | cond | zmirror | synthetic")
        p.add_argument("trial", type=int, nargs="?", default=0)
        p.add_argument("--f32", action="store_true",
                       help="float32 step path (default: float64)")
        p.add_argument("--solver", choices=("inv", "cg", "cg_matfree"),
                       default=None,
                       help="charge solver override (default: deck choice; "
                            "the reference's is inv, fix_conp.cpp:90)")
        p.add_argument("--pair-path", choices=PAIR_PATHS, default=None,
                       help="real-space pair path override")
        p.add_argument("--kmax", type=int, default=None,
                       help="Verlet-list per-atom capacity override (default: "
                            "sized from the max neighbor count at x0)")

    p = sub.add_parser("run")
    add_common(p)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--thermo", type=int, default=20)
    p.add_argument("--log", default=None)
    p.add_argument("--dump", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--no-timing", action="store_true",
                   help="skip the per-phase timing flush at run end")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("run-suite")
    add_common(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--thermo", type=int, default=20)
    p.set_defaults(fn=cmd_run_suite)

    p = sub.add_parser("rerun")
    add_common(p)
    p.add_argument("traj")
    p.set_defaults(fn=cmd_rerun)

    p = sub.add_parser("compare")
    p.add_argument("logs", nargs="+")
    p.add_argument("--column", default="c_qleft")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("profile")
    add_common(p)
    p.add_argument("--iters", type=int, default=10)
    p.set_defaults(fn=cmd_profile)

    args = ap.parse_args(argv)
    from . import enable_compile_cache
    enable_compile_cache()
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())

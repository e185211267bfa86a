#!/usr/bin/env python
"""Compile-latency diagnostic for the 100k production step program.

Traces (without compiling) the engine's chained run program at the
workloads.capacitor_100k configuration, then reports the StableHLO module
size and the op-frequency histogram — the "count HLO ops" step of hunting
a slow cold compile.

Usage: python tools/compile_diag.py [natoms_elyte] [nsteps] [--compile]
"""
import collections
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from lammps_user_conp2_tpu import workloads
from lammps_user_conp2_tpu.models.conp import setup_conp
from lammps_user_conp2_tpu.models.md import build_engine


def histogram(text):
    ops = collections.Counter(re.findall(r"stablehlo\.\w+|func\.call", text))
    return ops


def main():
    n_elyte = int(sys.argv[1]) if len(sys.argv) > 1 else 98304
    nsteps = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    do_compile = "--compile" in sys.argv
    t0 = time.time()
    system, md, cfg = workloads.capacitor_100k(n_elyte=n_elyte)
    conp = setup_conp(system, md, cfg, solve_dtype=jnp.float32)
    eng = build_engine(system, md, conp, dtype=jnp.float32)
    print(f"setup done {time.time()-t0:.0f}s", file=sys.stderr, flush=True)

    # abstract state spec: eval_shape traces init_state (jit inlines under
    # abstract tracing) without compiling or touching the device
    t0 = time.time()
    spec = jax.eval_shape(eng.init_state)
    print(f"eval_shape(init) {time.time()-t0:.1f}s", file=sys.stderr,
          flush=True)

    t0 = time.time()
    run = eng._make_run(nsteps, 0)
    lowered = run.lower(spec)
    print(f"trace+lower {time.time()-t0:.1f}s", file=sys.stderr, flush=True)
    text = lowered.as_text()
    lines = text.count("\n")
    hist = histogram(text)
    total = sum(hist.values())
    print(f"stablehlo: {lines} lines, {total} ops, {len(text)/1e6:.1f} MB")
    for op, n in hist.most_common(15):
        print(f"  {n:7d}  {op}")
    # largest embedded constants: trace-time-baked numpy arrays; at 100k
    # these (not op count) are what makes the compile minutes-long
    sizes = collections.Counter()
    for m in re.finditer(r"stablehlo\.constant.*?tensor<([0-9x]+)x(\w+)>",
                         text):
        dims, dt = m.group(1), m.group(2)
        nelt = 1
        for d in dims.split("x"):
            nelt *= int(d)
        bytes_ = nelt * (8 if "64" in dt else 4 if "32" in dt
                         else 2 if "16" in dt else 1)
        sizes[f"{dims}x{dt}"] += bytes_
    print("top constants (total bytes by shape):")
    for shp, b in sizes.most_common(25):
        if b > 1 << 20:
            print(f"  {b/1e6:9.1f} MB  {shp}")
    if do_compile:
        t0 = time.time()
        lowered.compile()
        print(f"compile {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()

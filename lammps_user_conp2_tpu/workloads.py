"""Reference test decks re-expressed as workload builders.

Each function mirrors one env-var-parameterized LAMMPS input from
/root/reference/tests/ (see SURVEY.md section 4) and returns
(System, MDConfig, ConpConfig) ready for build_engine/setup_conp.

Trial numbering follows the reference inputs exactly, e.g. dilute
(tests/dilute/input:4-10): 0=conp slab, 1=+etypes (a no-op for the dense
pair path), 2=conp ffield [+efield], 3=noslab zneutr sym, 4=anti, 5=ffield
rerun.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .models.system import System, build_system, electrodes_first
from .utils import data_io
from .utils.config import (ConpConfig, FFMode, KSpaceStyle, MDConfig, Mode,
                           ShakeConfig, ThermostatConfig)

REF_TESTS = os.environ.get("CONP_REF_TESTS", "/root/reference/tests")

# explicit pair_coeff lines from tests/dilute/input:29-38
_DILUTE_PAIR_COEFFS = [
    (1, 1, 0.09935850, 3.40000000),
    (1, 2, 0.19419428, 3.50000000),
    (1, 3, 0.07390356, 3.38500000),
    (1, 4, 0.09935850, 3.35000000),
    (2, 2, 0.37954900, 3.60000000),
    (2, 3, 0.14444310, 3.48500000),
    (2, 4, 0.19419428, 3.45000000),
    (3, 3, 0.05497000, 3.37000000),
    (3, 4, 0.07390356, 3.33500000),
    (4, 4, 0.09935850, 3.30000000),
]


def _sol_thermostats(data, groups, doubled: bool, temp: float):
    """Thermostat configs matching the reference decks: single NHC on 'sol'
    normally; TWO independent NHCs (solpos + solneg) for doubled-cell trials
    (il_onelayer/input:113-116 'fix 1 solpos nvt' + 'fix 2 solneg nvt')."""
    if not doubled:
        return (ThermostatConfig("sol", temp, temp, 100.0),)
    pos = data.x[:, 2] > 0.0
    groups["solpos"] = groups["sol"] & pos
    groups["solneg"] = groups["sol"] & ~pos
    return (ThermostatConfig("solpos", temp, temp, 100.0),
            ThermostatConfig("solneg", temp, temp, 100.0))


def _doubled_cell(data, molleft, molright, sym: bool, flip_vz: bool = False):
    """replicate 1 1 2 + change_box + sym/anti mol reassignment
    (tests/dilute/input:44-57, il_onelayer/input:34-47)."""
    molmax = int(data.mol.max())
    data = data_io.replicate_z2(data)
    data = data_io.change_box_z_centered(data)
    pos = data.x[:, 2] > 0.0
    if sym:
        data = data_io.mirror_group_z(data, pos, flip_vz=flip_vz)
        data = data_io.set_mol(data, molmax + molright, molright)
        data = data_io.set_mol(data, molmax + molleft, molleft)
    else:
        data = data_io.set_mol(data, molmax + molright, molleft)
        data = data_io.set_mol(data, molmax + molleft, molright)
    return data


def synthetic(n_elyte: int = 64, nele_side: int = 4, *, lz: float = 30.0,
              lxy: float = 12.0):
    """Self-contained parallel-plate capacitor (no reference files needed):
    two square electrode walls + a lattice of +-1 LJ ions between them.
    Deterministic construction — used by __graft_entry__ and quick tests."""
    import dataclasses as _dc

    from .utils.data_io import LammpsData

    ne = nele_side * nele_side
    a = lxy / nele_side
    xs = []
    # left wall at z=2, right wall at z=lz-2
    for side, z in ((0, 2.0), (1, lz - 2.0)):
        for i in range(nele_side):
            for j in range(nele_side):
                xs.append([a * (i + 0.5), a * (j + 0.5), z])
    # ion lattice in between (alternating charges)
    m = int(np.ceil(n_elyte ** (1.0 / 3.0)))
    count = 0
    for i in range(m):
        for j in range(m):
            for k in range(m):
                if count >= n_elyte:
                    break
                xs.append([
                    lxy * (i + 0.5) / m,
                    lxy * (j + 0.5) / m,
                    6.0 + (lz - 12.0) * (k + 0.5) / m,
                ])
                count += 1
    x = np.array(xs)
    nat = len(x)
    typ = np.concatenate([np.full(2 * ne, 3), 1 + (np.arange(n_elyte) % 2)])
    q = np.concatenate([np.zeros(2 * ne),
                        np.where(np.arange(n_elyte) % 2 == 0, 1.0, -1.0)])
    mol = np.concatenate([np.full(ne, 1), np.full(ne, 2),
                          3 + np.arange(n_elyte)])
    data = LammpsData(
        natoms=nat, natomtypes=3,
        box_lo=np.zeros(3), box_hi=np.array([lxy, lxy, lz]),
        tag=np.arange(1, nat + 1), mol=mol, type=typ, q=q, x=x,
        v=np.zeros((nat, 3)),
        mass_by_type=np.array([0.0, 23.0, 35.5, 12.0]),
        pair_coeffs=np.array([[0, 0], [0.1, 2.5], [0.1, 3.4], [0.05, 3.4]]),
        pair_coeffs_ij=None,
        bond_coeffs=np.zeros((1, 2)), angle_coeffs=np.zeros((1, 2)),
        bonds=np.zeros((0, 3), np.int64), angles=np.zeros((0, 4), np.int64),
    )
    groups = {"sol": typ != 3, "ele": typ == 3}
    system = build_system(
        data, units="real", periodic=(True, True, False), mix="arithmetic",
        ele_left=[1], ele_right=[2], groups=groups)
    md = MDConfig(
        units="real", dt=1.0, cutoff=5.0, kspace_accuracy=1e-4, slab=3.0,
        thermostats=(ThermostatConfig("sol", 300.0, 300.0, 100.0),),
    )
    cfg = ConpConfig(mode=Mode.CONP, nevery=1, eta=1.979, target=1.0,
                     ff=FFMode.NORMAL)
    return system, md, cfg


def capacitor_il(**size):
    """The synthetic capacitor at il-deck size (~3.8k atoms) and the ion
    density of capacitor_100k: dense pair sweep, factorised Ewald, INV
    solve.  ``size`` overrides synthetic()'s size arguments."""
    kw = dict(n_elyte=3456, nele_side=12, lz=80.0, lxy=40.0)
    kw.update(size)
    return synthetic(**kw)


def capacitor_100k(**size):
    """The synthetic capacitor at production size: 98,304 ions plus 2x23^2
    electrode atoms, PPPM mesh k-space, INV solve, Verlet neighbor list.
    ``size`` overrides synthetic()'s size arguments."""
    import dataclasses as _dc

    kw = dict(n_elyte=98304, nele_side=23, lz=240.0, lxy=120.0)
    kw.update(size)
    system, md, cfg = synthetic(**kw)
    md = _dc.replace(md, kspace_style=KSpaceStyle.PPPM, pair_path="nlist")
    cfg = _dc.replace(cfg, kspace=KSpaceStyle.PPPM)
    return system, md, cfg


def rotors(m: int = 320, *, seed: int = 0, spacing: float = 7.0):
    """Rigid bent 3-site molecules on a jittered lattice — the constraint
    shape of the il decks' BMI cations (two bonds plus one angle, one
    3-atom SHAKE cluster per molecule) with no deck file.  The angle is
    bent: for collinear sites the three distance constraints are
    degenerate and SHAKE cannot converge.  Molecules cross the periodic
    x/y faces.  Returns (System, ShakeConfig)."""
    from .utils.data_io import LammpsData

    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(m / 4.0)))
    nz = int(np.ceil(m / (side * side)))
    lxy, lz = side * spacing, nz * spacing
    r1, r2, theta = 2.2, 2.6, 110.0         # bond lengths, angle (degrees)
    cell = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                                np.arange(nz), indexing="ij"),
                    axis=-1).reshape(-1, 3)[:m]
    center = (cell + 0.5) * spacing + rng.uniform(-1.0, 1.0, (m, 3))
    rot = np.linalg.qr(rng.normal(size=(m, 3, 3)))[0]   # random frames
    th = np.deg2rad(theta)
    local = np.array([[-r1, 0.0, 0.0], [0.0, 0.0, 0.0],
                      [-r2 * np.cos(th), r2 * np.sin(th), 0.0]])
    x = center[:, None, :] + np.einsum("mij,aj->mai", rot, local)
    x[..., :2] %= lxy                       # wrap: some molecules straddle
    x = x.reshape(-1, 3)
    nat = 3 * m
    base = 3 * np.arange(m)
    bonds = np.concatenate([
        np.stack([np.full(m, 1), base, base + 1], axis=1),
        np.stack([np.full(m, 2), base + 1, base + 2], axis=1)])
    angles = np.stack([np.full(m, 1), base, base + 1, base + 2], axis=1)
    data = LammpsData(
        natoms=nat, natomtypes=3,
        box_lo=np.zeros(3), box_hi=np.array([lxy, lxy, lz]),
        tag=np.arange(1, nat + 1), mol=np.repeat(np.arange(1, m + 1), 3),
        type=np.tile([1, 2, 3], m), q=np.zeros(nat), x=x,
        v=np.zeros((nat, 3)),
        mass_by_type=np.array([0.0, 15.0, 42.0, 57.0]),
        pair_coeffs=np.array([[0, 0], [0.1, 3.4], [0.1, 3.4], [0.1, 3.4]]),
        pair_coeffs_ij=None,
        bond_coeffs=np.array([[0.0, 0.0], [300.0, r1], [300.0, r2]]),
        angle_coeffs=np.array([[0.0, 0.0], [50.0, theta]]),
        bonds=bonds.astype(np.int64), angles=angles.astype(np.int64),
    )
    system = build_system(data, units="real", periodic=(True, True, False),
                          mix="arithmetic", groups={"bmi": np.ones(nat, bool)})
    return system, ShakeConfig(group="bmi", btypes=(1, 2), atypes=(1,))


def dilute(n: int = 0, *, data_path: Optional[str] = None):
    """tests/dilute/input — 432-atom smoke system."""
    data = data_io.parse_data_file(data_path or f"{REF_TESTS}/dilute/data")
    molleft, molright = 81, 82
    doubled = n in (3, 4)
    if doubled:
        data = _doubled_cell(data, molleft, molright, sym=(n == 3))
    periodic = (True, True, n > 1)

    groups = {
        "sol": np.isin(data.type, [1, 2, 4]),
        "ele": data.type == 3,
    }
    thermos = _sol_thermostats(data, groups, doubled, 298.0)
    system = build_system(
        data, units="real", periodic=periodic, mix="geometric",
        pair_coeff_overrides=_DILUTE_PAIR_COEFFS,
        ele_left=[molleft], ele_right=[molright], groups=groups)
    system = electrodes_first(system)

    ff = {0: FFMode.NORMAL, 1: FFMode.NORMAL, 2: FFMode.FFIELD,
          3: FFMode.NOSLAB, 4: FFMode.NOSLAB, 5: FFMode.FFIELD}[n]
    v = 1.0
    md = MDConfig(
        units="real", dt=1.0, cutoff=4.0, kspace_accuracy=1e-6,
        slab=3.0 if n <= 1 else None,
        efield=(0.0, 0.0, -v / system.box[2]) if ff is FFMode.FFIELD else None,
        thermostats=thermos,
    )
    cfg = ConpConfig(mode=Mode.CONP, nevery=1, eta=1.979, target=v,
                     ff=ff, zneutr=doubled)
    return system, md, cfg


def il_onelayer(n: int = 0, *, data_path: Optional[str] = None):
    """tests/il_onelayer/input — 3776-atom BMI-PF6 + single-layer graphene."""
    data = data_io.parse_data_file(data_path or f"{REF_TESTS}/il_onelayer/data")
    molleft, molright = 641, 642
    etype = 5
    doubled = n in (5, 6)
    if doubled:
        data = _doubled_cell(data, molleft, molright, sym=(n == 5), flip_vz=(n == 5))
    periodic = (True, True, n > 2)

    groups = {
        "sol": np.isin(data.type, [1, 2, 3, 4]),
        "bmi": np.isin(data.type, [1, 2, 3]),
        "ele": data.type == etype,
    }
    thermos = _sol_thermostats(data, groups, doubled, 500.0)
    system = build_system(
        data, units="real", periodic=periodic, mix="arithmetic",
        ele_left=[molleft], ele_right=[molright], groups=groups)
    system = electrodes_first(system)

    v = 2.0
    ff = FFMode.NORMAL
    mode = Mode.CONP
    target = v
    kspace = KSpaceStyle.EWALD
    if n in (3, 4, 7):
        ff = FFMode.FFIELD
    if n in (5, 6):
        ff = FFMode.NOSLAB
    if n == 2:
        mode = Mode.CONQ
        target = v
        kspace = KSpaceStyle.PPPM
    if n == 4:
        kspace = KSpaceStyle.PPPM
        # the reference deck drives trial 4 with the equal-style variable
        # v_v (il_onelayer/input:103) — wire it as a callable target to
        # exercise the same machinery (fix_conp.cpp:112-117, 1143)
        target = lambda step: v  # noqa: E731
    ehgo = None
    from .utils.config import EhgoConfig, PairMode
    pairmode = PairMode.ETA
    if n == 4:
        pairmode = PairMode.EHGO
        ehgo = EhgoConfig(kappa=0.0, eta_by_type=((etype, 1.979, None),))

    md = MDConfig(
        units="real", dt=2.0, cutoff=16.0, kspace_accuracy=1e-7,
        slab=3.0 if n <= 2 else None,
        efield=(0.0, 0.0, -v / system.box[2]) if ff is FFMode.FFIELD else None,
        thermostats=thermos,
        shake=ShakeConfig(group="bmi", btypes=(1, 2), atypes=(1,)),
    )
    cfg = ConpConfig(mode=mode, nevery=1, eta=1.979, target=target,
                     ff=ff, zneutr=doubled, pairmode=pairmode, ehgo=ehgo,
                     kspace=kspace)
    return system, md, cfg


def cond(n: int = 0, *, data_path: Optional[str] = None, suite: str = "cond"):
    """tests/cond/input — conp/conq/cond at 3776 atoms (cond2: larger, Q=50).

    0=conp slab pppm, 1=conq slab pppm (Q=0.35), 2=conp ffield pppm [+efield],
    3=conq ffield pppm [+feedback efield], 4=cond ffield pppm [+feedback]."""
    data = data_io.parse_data_file(data_path or f"{REF_TESTS}/{suite}/data")
    molleft, molright = 641, 642
    etype = 5
    periodic = (True, True, n > 1)
    groups = {
        "sol": np.isin(data.type, [1, 2, 3, 4]),
        "bmi": np.isin(data.type, [1, 2, 3]),
        "ele": data.type == etype,
    }
    system = build_system(
        data, units="real", periodic=periodic, mix="arithmetic",
        ele_left=[molleft], ele_right=[molright], groups=groups)
    system = electrodes_first(system)

    v = 2.0
    qtarget = 50.0 if suite == "cond2" else 0.35
    mode = {0: Mode.CONP, 1: Mode.CONQ, 2: Mode.CONP, 3: Mode.CONQ,
            4: Mode.COND}[n]
    ff = FFMode.NORMAL if n <= 1 else FFMode.FFIELD
    target = v if mode is Mode.CONP else qtarget
    md = MDConfig(
        units="real", dt=2.0, cutoff=16.0, kspace_accuracy=1e-7,
        slab=3.0 if n <= 1 else None,
        efield=(0.0, 0.0, -v / system.box[2]) if n == 2 else None,
        efield_feedback=n in (3, 4),
        thermostats=(ThermostatConfig("sol", 500.0, 500.0, 100.0),),
        shake=ShakeConfig(group="bmi", btypes=(1, 2), atypes=(1,)),
    )
    cfg = ConpConfig(mode=mode, nevery=1, eta=1.979, target=target, ff=ff,
                     kspace=KSpaceStyle.PPPM)
    return system, md, cfg


def zmirror(n: int = 0, *, data_path: Optional[str] = None):
    """tests/zmirror/input — doubled-cell mirror-symmetry NEMD.

    0=conp noslab zneutr [sym], 1=+pppm, 2=+zmirror fix (pos half mirrors neg
    each step instead of being thermostatted), 3=conq+zmirror."""
    from .utils.config import ZMirrorConfig

    data = data_io.parse_data_file(data_path or f"{REF_TESTS}/zmirror/data")
    molmax = int(data.mol.max())
    molleft, molright = 641, 642
    etype = 5
    data = _doubled_cell(data, molleft, molright, sym=True, flip_vz=True)
    # eleleft/eleright span BOTH halves (zmirror/input:49-50)
    pos = data.x[:, 2] > 0.0
    sol = np.isin(data.type, [1, 2, 3, 4])
    groups = {
        "sol": sol,
        "bmi": np.isin(data.type, [1, 2, 3]),
        "solpos": sol & pos,
        "solneg": sol & ~pos,
        "ele": data.type == etype,
    }
    system = build_system(
        data, units="real", periodic=(True, True, True), mix="arithmetic",
        ele_left=[molleft, molleft + molmax],
        ele_right=[molright, molright + molmax], groups=groups)
    system = electrodes_first(system)

    v = 2.0
    use_zm = n in (2, 3)
    mode = Mode.CONQ if n == 3 else Mode.CONP
    target = 2 * 0.35 if n == 3 else v
    thermostats = [ThermostatConfig("solneg", 500.0, 500.0, 100.0)]
    if not use_zm:
        thermostats.append(ThermostatConfig("solpos", 500.0, 500.0, 100.0))
    md = MDConfig(
        units="real", dt=2.0, cutoff=16.0, kspace_accuracy=1e-7, slab=None,
        thermostats=tuple(thermostats),
        shake=ShakeConfig(group="bmi", btypes=(1, 2), atypes=(1,)),
        zmirror=ZMirrorConfig("solneg", "solpos", 1) if use_zm else None,
    )
    cfg = ConpConfig(mode=mode, nevery=1, eta=1.979, target=target,
                     ff=FFMode.NOSLAB, zneutr=True,
                     kspace=KSpaceStyle.PPPM if n >= 1 else KSpaceStyle.EWALD)
    return system, md, cfg


def il_twolayer(n: int = 0, *, data_path: Optional[str] = None):
    """tests/il_twolayer/input — the BASELINE.md north-star workload."""
    data = data_io.parse_data_file(data_path or f"{REF_TESTS}/il_twolayer/data")
    molleft, molright = 641, 642
    etype = 5
    doubled = n in (3, 4)
    if doubled:
        data = _doubled_cell(data, molleft, molright, sym=(n == 3), flip_vz=(n == 3))
    periodic = (True, True, n > 1)

    groups = {
        "sol": np.isin(data.type, [1, 2, 3, 4]),
        "bmi": np.isin(data.type, [1, 2, 3]),
        "ele": data.type == etype,
    }
    thermos = _sol_thermostats(data, groups, doubled, 500.0)
    system = build_system(
        data, units="real", periodic=periodic, mix="arithmetic",
        ele_left=[molleft], ele_right=[molright], groups=groups)
    system = electrodes_first(system)

    v = 2.0
    ff = {0: FFMode.NORMAL, 1: FFMode.NORMAL, 2: FFMode.FFIELD,
          3: FFMode.NOSLAB, 4: FFMode.NOSLAB, 5: FFMode.FFIELD}[n]
    md = MDConfig(
        units="real", dt=2.0, cutoff=16.0, kspace_accuracy=1e-7,
        slab=3.0 if n <= 1 else None,
        efield=(0.0, 0.0, -v / system.box[2]) if ff is FFMode.FFIELD else None,
        thermostats=thermos,
        shake=ShakeConfig(group="bmi", btypes=(1, 2), atypes=(1,)),
    )
    cfg = ConpConfig(mode=Mode.CONP, nevery=1, eta=1.979, target=v,
                     ff=ff, zneutr=doubled)
    return system, md, cfg

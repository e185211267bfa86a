"""fix zmirror: enforce z-mirror symmetry between two matched groups.

Reference: fix_zmirror.{h,cpp} — every N steps the atoms of group2 are
placed at group1's coordinates mirrored through the z midplane
(z' = 2*zlo + Lz - z, fix_zmirror.cpp:132/163/215), paired by tag offset
(setup checks equal tag-contiguous ranges, fix_zmirror.cpp:63-95).

Form here: the tag pairing is a STATIC permutation computed once on
the host, so the whole fix is one gather + affine transform inside the
jitted step — the reference's local-fast-path/Allgatherv machinery
(fix_zmirror.cpp:153-220) has no equivalent cost here.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .system import System


@dataclasses.dataclass(frozen=True)
class ZMirror:
    src_idx: jnp.ndarray     # (M,) atoms of group1 (source)
    dst_idx: jnp.ndarray     # (M,) atoms of group2 (mirrored copies)
    zoffset: float           # 2*zlo + Lz
    every: int

    def apply(self, x, step=None):
        """Mirror group1 onto group2; call post-integrate every `every` steps."""
        src = x[self.src_idx]
        mirrored = jnp.stack(
            [src[:, 0], src[:, 1], self.zoffset - src[:, 2]], axis=1)
        xnew = x.at[self.dst_idx].set(mirrored)
        if step is None or self.every == 1:
            return xnew
        return jnp.where(step % self.every == 0, xnew, x)


def build_zmirror(system: System, group1: str, group2: str, every: int = 1) -> ZMirror:
    m1 = system.groups[group1]
    m2 = system.groups[group2]
    t1 = system.tag[m1]
    t2 = system.tag[m2]
    if len(t1) != len(t2):
        raise ValueError("zmirror groups must be the same size")
    lo1, hi1 = t1.min(), t1.max()
    lo2, hi2 = t2.min(), t2.max()
    if hi1 - lo1 + 1 != len(t1) or hi2 - lo2 + 1 != len(t2):
        raise ValueError("zmirror groups must be tag-contiguous "
                         "(fix_zmirror.cpp:63-95)")
    idx1 = np.nonzero(m1)[0]
    idx2 = np.nonzero(m2)[0]
    # order both by tag so dst[k] mirrors src[k] (tag offset pairing)
    idx1 = idx1[np.argsort(system.tag[idx1])]
    idx2 = idx2[np.argsort(system.tag[idx2])]
    zoffset = 2 * float(system.box_lo[2]) + system.box[2]
    return ZMirror(src_idx=jnp.asarray(idx1), dst_idx=jnp.asarray(idx2),
                   zoffset=zoffset, every=every)

"""The reference of the tests' slab: the bench physics of
``reference/sph.py`` in the slab's box, and no phase change."""

from __future__ import annotations

from sphbench.reference.sph import Physics, step  # noqa: F401


def rule(cfg, types, ph, s, out, pl):
    """The slab has no phase change."""
    return None

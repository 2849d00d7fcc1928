"""The check that a run loaded no module of JAX or of the JAX package.

Modules are compared by their top-level name (the part before the first
dot), whole: `hsrans_tpu_torch` is the program under test, `hsrans_tpu`
the JAX package it was ported from.
"""

from __future__ import annotations

import sys
from collections.abc import Iterable

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hsrans_tpu", "chip_smoke"})


def forbidden(modules: Iterable[str] | None = None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)

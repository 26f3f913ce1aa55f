"""The check that no JAX code is loaded: the top-level name of every
module in `sys.modules` (the part before the first dot) compared whole,
so `mtgs_torch` (whose name begins as `mtgs_tpu`'s does) passes."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mtgs_tpu"})


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among the loaded modules, sorted."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)

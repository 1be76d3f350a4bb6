"""The check that nothing a run loaded is JAX or the JAX package.

Each module's top-level name (the part before the first dot) is compared
whole, so `gabby_tpu_torch` is not `gabby_tpu`."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "gabby_tpu")


def forbidden(modules=None) -> list[str]:
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))

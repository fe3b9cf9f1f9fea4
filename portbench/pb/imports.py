"""The modules a run may not load, compared by whole top-level name (the
part before the first dot): ``graspldm_tpu_torch`` is the program and may
load; ``graspldm_tpu`` is the JAX package and may not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "graspldm_tpu")
# the reference may not load the program either
FORBIDDEN_IN_REFERENCE = FORBIDDEN + ("graspldm_tpu_torch",)


def top_level(names: Iterable[str]) -> set:
    return {n.split(".", 1)[0] for n in names}


def forbidden_loaded(modules: Iterable[str] = None, forbidden=FORBIDDEN) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: loaded)."""
    return sorted(top_level(sys.modules if modules is None else modules) & set(forbidden))

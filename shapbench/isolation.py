"""The check that the run loaded neither JAX nor the JAX package: whole
top-level module names (the part before the first dot) compared, so that
``asr_shap_torch`` is not taken for ``asr_shap``."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "asr_shap"})


def forbidden(modules: Iterable[str]) -> List[str]:
    """The forbidden top-level names among ``modules`` (names or a
    ``sys.modules`` mapping), sorted."""
    return sorted({m.split(".", 1)[0] for m in modules} & FORBIDDEN)

"""The benchmark's guard against JAX: the measured program is the PyTorch
port, which must run without JAX and without the JAX package beside it.

``install()`` puts a finder first on ``sys.meta_path`` that refuses to
import any module whose top-level name (the part before the first dot) is
one of ``FORBIDDEN``; the name is compared whole, so ``cmsbwt_tpu_torch``
passes and ``cmsbwt_tpu`` does not. ``loaded()`` lists such modules that
``sys.modules`` holds anyway (a native library can import without the
finder), which a run checks once its window has closed.
"""
from __future__ import annotations

import importlib.abc
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cmsbwt_tpu"})


def forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


class NoJax(importlib.abc.MetaPathFinder):
    """Refuse JAX and the JAX package."""

    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            raise ImportError(f"{name}: refused by the benchmark (the "
                              "measured program imports neither JAX nor "
                              "the JAX package)")
        return None


def install() -> None:
    if not any(isinstance(f, NoJax) for f in sys.meta_path):
        sys.meta_path.insert(0, NoJax())


def loaded() -> list[str]:
    return sorted(m for m in list(sys.modules) if forbidden(m))

"""Similarity engine configuration types.

Counterpart of the config half of ``stringzilla_tpu/ops/similarity.py``,
with the same fields, so one configuration describes an engine of either
package. The column-DP cell math that serves non-unit costs comes with the
port of the column-DP kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

__all__ = ["UniformCosts", "ClassCosts", "LinearGaps", "AffineGaps",
           "SimilarityConfig"]


@dataclasses.dataclass(frozen=True)
class UniformCosts:
    """Match/mismatch substitution costs (``uniform_substitution_costs_t``,
    reference ``serial.hpp:102-111``)."""

    match: int = 0
    mismatch: int = 1


@dataclasses.dataclass(frozen=True)
class ClassCosts:
    """256→32-class map + 32x32 signed cost table (``error_costs_32x32_t``,
    reference ``serial.hpp:118-189``), stored as nested tuples so the
    config stays hashable."""

    byte_to_class: tuple  # length-256 tuple of ints
    table: tuple  # 32x32 nested tuple of ints

    @classmethod
    def from_arrays(cls, byte_to_class, table) -> "ClassCosts":
        b = np.asarray(byte_to_class, dtype=np.uint8)
        t = np.asarray(table, dtype=np.int32)
        if b.shape != (256,) or t.shape != (32, 32):
            raise ValueError("byte_to_class must be [256], table must be [32,32]")
        return cls(
            byte_to_class=tuple(int(x) for x in b),
            table=tuple(tuple(int(x) for x in row) for row in t),
        )

    def byte_to_class_np(self) -> np.ndarray:
        return np.asarray(self.byte_to_class, dtype=np.uint8)

    def table_np(self) -> np.ndarray:
        return np.asarray(self.table, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class LinearGaps:
    """``linear_gap_costs_t`` (reference ``serial.hpp:70-75``)."""

    open_or_extend: int = 1


@dataclasses.dataclass(frozen=True)
class AffineGaps:
    """``affine_gap_costs_t`` — a run of k gaps costs ``open + extend*(k-1)``
    (reference ``serial.hpp:77-88,1135-1146``)."""

    open: int = 1
    extend: int = 1


@dataclasses.dataclass(frozen=True)
class SimilarityConfig:
    """What an engine computes: objective, locality, gaps and costs."""

    objective: Literal["min", "max"] = "min"
    locality: Literal["global", "local"] = "global"
    gaps: LinearGaps | AffineGaps = LinearGaps(1)
    costs: UniformCosts | ClassCosts = UniformCosts(0, 1)

    @property
    def is_affine(self) -> bool:
        return isinstance(self.gaps, AffineGaps)

    @property
    def is_local(self) -> bool:
        return self.locality == "local"

    @property
    def uses_classes(self) -> bool:
        return isinstance(self.costs, ClassCosts)

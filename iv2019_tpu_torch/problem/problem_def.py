"""Problem-definition (label-space) core.

A *problem definition* is a JSON file describing a label space:

- ``lids2cids``: raw dataset label id -> training class id (``-1`` = void)
- ``cids2labels``: class id -> human-readable name
- ``cids2colors``: class id -> RGB color (for plotting / export)
- ``cids2lids``: class id -> raw label id (inverse map, for export)
- optional ``training_cids2inference_cids`` / ``training_cids2evaluation_cids``

Reference parity: reference system_factory.py:79-157 (loading and
derived cid maps), reference utils/utils.py:286-289
(``_replacevoids``), reference problem_definitions/*/problem01.json
(schema).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "ProblemDef",
    "replace_voids",
    "derive_output_num_classes",
    "load_problem_def",
]


def replace_voids(mappings: Sequence[int]) -> list[int]:
    """Replace ``-1`` (void) entries with ``max(mappings) + 1``.

    By convention void pixels are represented as ``-1`` in problem-definition
    mappings and are internally mapped to one extra trailing class id.
    (reference: utils/utils.py:286-289)
    """
    max_m = max(mappings)
    return [m if m != -1 else max_m + 1 for m in mappings]


def derive_output_num_classes(lids2cids: Sequence[int], train_void_class: bool = False) -> int:
    """Number of classes the network outputs (incl. the void class if present).

    ``max(lids2cids) + 1 + (has_void or train_void_class)``
    (reference: system_factory.py:124-130). Holds only for the raw mapping,
    i.e. before ``replace_voids`` is applied.
    """
    has_void = -1 in lids2cids
    return max(lids2cids) + 1 + int(has_void or train_void_class)


@dataclasses.dataclass(frozen=True)
class ProblemDef:
    """Validated, immutable label-space definition."""

    lids2cids: tuple[int, ...]
    cids2labels: tuple[str, ...]
    cids2colors: tuple[tuple[int, int, int], ...]
    cids2lids: tuple[int, ...]
    version: float = 1.0
    comments: str = ""
    # Optional remaps consumed at inference/evaluation time.
    training_cids2inference_cids: Optional[tuple[int, ...]] = None
    training_cids2evaluation_cids: Optional[tuple[int, ...]] = None

    # -- derived -----------------------------------------------------------

    @property
    def has_void(self) -> bool:
        return -1 in self.lids2cids

    def output_num_classes(self, train_void_class: bool = False) -> int:
        return derive_output_num_classes(self.lids2cids, train_void_class)

    @property
    def num_classes(self) -> int:
        """max cid + 1, not counting a void class."""
        return max(self.lids2cids) + 1

    def lids2cids_voids_replaced(self) -> np.ndarray:
        """int32 lookup table with void (-1) mapped to the trailing class id."""
        return np.asarray(replace_voids(self.lids2cids), dtype=np.int32)

    def palette(self) -> np.ndarray:
        """(Nc, 3) uint8 RGB palette for class-id colorization."""
        return np.asarray(self.cids2colors, dtype=np.uint8)

    def validate(self) -> None:
        """Check the continuity invariant of class ids.

        ``lids2cids`` must cover exactly ``{0..max}`` (minus void -1)
        (reference: system_factory.py:455-461).
        """
        unique = set(self.lids2cids)
        cid_max = max(unique)
        unique.discard(-1)
        if unique != set(range(cid_max + 1)):
            raise ValueError(
                "lids2cids field in training problem definition contains "
                "non-continuous class ids."
            )
        n = self.output_num_classes(train_void_class=False)
        if len(self.cids2labels) not in (n, n - 1 if self.has_void else n):
            # labels must cover all classes (incl. void by convention)
            raise ValueError(
                f"cids2labels has {len(self.cids2labels)} entries, expected {n}."
            )
        if len(self.cids2colors) != len(self.cids2labels):
            raise ValueError("cids2colors and cids2labels must have equal length.")

    # -- derived cid maps (system_factory.py:138-157) ----------------------

    def default_cids_remap(self, train_void_class: bool = False) -> list[int]:
        """Identity training->inference/evaluation map, voiding the void class."""
        n = self.output_num_classes(train_void_class)
        remap = list(range(n))
        if self.has_void and not train_void_class:
            remap[-1] = -1
        return remap

    def inference_cids_map(self, train_void_class: bool = False) -> list[int]:
        if self.training_cids2inference_cids is not None:
            return list(self.training_cids2inference_cids)
        return self.default_cids_remap(train_void_class)

    def evaluation_cids_map(self, train_void_class: bool = False) -> list[int]:
        if self.training_cids2evaluation_cids is not None:
            return list(self.training_cids2evaluation_cids)
        return self.default_cids_remap(train_void_class)


def load_problem_def(path: str) -> ProblemDef:
    """Load and validate a problem-definition JSON file."""
    with open(path, "r") as fp:
        raw = json.load(fp)
    pd = ProblemDef(
        lids2cids=tuple(raw["lids2cids"]),
        cids2labels=tuple(raw["cids2labels"]),
        cids2colors=tuple(tuple(c) for c in raw["cids2colors"]),
        cids2lids=tuple(raw.get("cids2lids", ())),
        version=raw.get("version", 1.0),
        comments=raw.get("comments", ""),
        training_cids2inference_cids=(
            tuple(raw["training_cids2inference_cids"])
            if "training_cids2inference_cids" in raw
            else None
        ),
        training_cids2evaluation_cids=(
            tuple(raw["training_cids2evaluation_cids"])
            if "training_cids2evaluation_cids" in raw
            else None
        ),
    )
    pd.validate()
    return pd

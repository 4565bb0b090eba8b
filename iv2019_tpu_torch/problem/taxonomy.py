"""Hierarchical taxonomy tables for the three-classifier label hierarchy.

The model has a root ("L1") classifier plus two subclass ("L2") classifiers
for *vehicle* and *human*. Supervision arrives in three label spaces
(per-pixel dataset cids, OpenImages bbox/image-label cids) and must be
projected into each classifier's label space; at inference the three heads'
decisions are fused into one *common* label space.

This module lifts every hard-coded table of the reference into one
declarative, validated structure:

- loss tables:     reference define_losses_hierarchical.py:38-93
- fusion tables:   reference resnet50_extended_model_hierarchical.py:95-117
- summary tables:  reference define_estimator_hierarchical.py:323-337
- OpenImages MID map: reference input_subset_bboxes_v2.py:38-53

Conventions: the last class id of every head's label space is *void*.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Taxonomy",
    "get_taxonomy",
    "OPEN_IMAGES_MID2CID",
    "OPEN_IMAGES_MID2CID_V1",
    "V1_CID2V2_CID",
    "NUM_WEAK_CLASSES",
]

# OpenImages v4 MID -> weak-label cid (15 classes, cid 14 = void).
# reference input_subset_bboxes_v2.py:38-53
OPEN_IMAGES_MID2CID = {
    "/m/0199g": 0,  # bicycle
    "/m/01bjv": 1,  # bus
    "/m/0k4j": 2,  # car
    "/m/04_sv": 3,  # motorcycle
    "/m/07jdr": 4,  # train
    "/m/07r04": 5,  # truck
    "/m/01g317": 6,  # human (person; may include rider)
    "/m/04yx4": 7,  # man
    "/m/03bt1vf": 8,  # woman
    "/m/01bl7v": 9,  # boy
    "/m/05r655": 10,  # girl
    "/m/015qff": 11,  # traffic light
    "/m/01mqdt": 12,  # traffic sign
    "/m/02pv19": 13,  # stop sign
    "void": 14,
}
NUM_WEAK_CLASSES = 15

# Legacy v1 aggregation (reference input_subset_bboxes.py:37-52): all five
# human MIDs collapse to one cid, traffic sign + stop sign merge; 10 classes
# with cid 9 = void.
OPEN_IMAGES_MID2CID_V1 = {
    "/m/0199g": 0,  # bicycle
    "/m/01bjv": 1,  # bus
    "/m/0k4j": 2,  # car
    "/m/04_sv": 3,  # motorcycle
    "/m/07jdr": 4,  # train
    "/m/07r04": 5,  # truck
    "/m/01g317": 6,  # person
    "/m/04yx4": 6,  # man
    "/m/03bt1vf": 6,  # woman
    "/m/01bl7v": 6,  # boy
    "/m/05r655": 6,  # girl
    "/m/015qff": 7,  # traffic light
    "/m/01mqdt": 8,  # traffic sign
    "/m/02pv19": 8,  # stop sign
    "void": 9,
}
# Injection of the v1 10-class space into the v2 15-class space: each v1
# class maps to its v2 representative (human -> person cid 6, merged signs ->
# traffic-sign cid 12), so the 15-class loss/fusion tables apply unchanged —
# by construction the v2 tables send every member of a v1 aggregate to the
# same head cid (e.g. per_bbox_cids2l1_cids[6..10] are all 'human').
V1_CID2V2_CID = np.asarray([0, 1, 2, 3, 4, 5, 6, 11, 12, 14], dtype=np.int32)


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int32)


# eq=False: ndarray fields are not comparable/hashable; identity semantics are
# fine (taxonomies are module-level singletons) and keep the object usable as
# a static attribute of flax modules.
@dataclasses.dataclass(frozen=True, eq=False)
class Taxonomy:
    """All label-space maps for one per-pixel dataset ('cityscapes'|'vistas')."""

    name: str

    # class counts of the three softmax heads (incl. their void class)
    num_l1_classes: int
    num_vehicle_classes: int
    num_human_classes: int
    # number of classes of the fused/common output space (= output_Nclasses)
    num_common_classes: int

    # L1 cids of the two metaclasses (gates for weak supervision)
    cid_l1_vehicle: int
    cid_l1_human: int

    # --- loss projection tables (define_losses_hierarchical.py:38-93) ---
    per_pixel_cids2l1_cids: np.ndarray
    per_bbox_cids2l1_cids: np.ndarray
    per_pixel_cids2vehicle_cids: np.ndarray
    per_bbox_cids2vehicle_cids: np.ndarray
    per_pixel_cids2human_cids: np.ndarray
    per_bbox_cids2human_cids: np.ndarray

    # --- decision fusion tables (resnet50_...model_hierarchical.py:95-117) ---
    l1_cids2common_cids: np.ndarray
    l2_vehicle_cids2common_cids: np.ndarray
    l2_human_cids2common_cids: np.ndarray

    # --- summary/colorization table (define_estimator_hierarchical.py:332,337) ---
    per_bbox_cids2common_cids: np.ndarray

    def validate(self) -> None:
        assert self.per_pixel_cids2l1_cids.max() == self.num_l1_classes - 1
        assert len(self.l1_cids2common_cids) == self.num_l1_classes
        assert len(self.l2_vehicle_cids2common_cids) == self.num_vehicle_classes
        assert len(self.l2_human_cids2common_cids) == self.num_human_classes
        for t in (
            self.per_bbox_cids2l1_cids,
            self.per_bbox_cids2vehicle_cids,
            self.per_bbox_cids2human_cids,
            self.per_bbox_cids2common_cids,
        ):
            assert len(t) == NUM_WEAK_CLASSES, "weak label space has 15 classes"
        assert self.per_pixel_cids2vehicle_cids.max() == self.num_vehicle_classes - 1
        assert self.per_pixel_cids2human_cids.max() == self.num_human_classes - 1
        assert self.l1_cids2common_cids.max() <= self.num_common_classes - 1
        assert self.l2_vehicle_cids2common_cids.max() <= self.num_common_classes - 1


_CITYSCAPES = Taxonomy(
    name="cityscapes",
    # heads: L1 14, vehicle 7, human 3; common space: 20 (19 + void)
    num_l1_classes=14,
    num_vehicle_classes=7,
    num_human_classes=3,
    num_common_classes=20,
    cid_l1_vehicle=12,
    cid_l1_human=11,
    # cityscapes train cids (20, void=19) -> L1 cids (14, void=13):
    # person(11)/rider(12)->human(11); car..bicycle(13..18)->vehicle(12)
    per_pixel_cids2l1_cids=_a(
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 11, 12, 12, 12, 12, 12, 12, 13]
    ),
    # weak 15-class cids -> L1 cids
    per_bbox_cids2l1_cids=_a([12, 12, 12, 12, 12, 12, 11, 11, 11, 11, 11, 13, 13, 13, 13]),
    # cityscapes cids -> vehicle head cids (7: car,truck,bus,train,motorcycle,bicycle,void)
    per_pixel_cids2vehicle_cids=_a(
        [6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 0, 1, 2, 3, 4, 5, 6]
    ),
    per_bbox_cids2vehicle_cids=_a([5, 2, 0, 4, 3, 1, 6, 6, 6, 6, 6, 6, 6, 6, 6]),
    # cityscapes cids -> human head cids (3: person, rider, void)
    per_pixel_cids2human_cids=_a(
        [2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 0, 1, 2, 2, 2, 2, 2, 2, 2]
    ),
    per_bbox_cids2human_cids=_a([2, 2, 2, 2, 2, 2, 0, 0, 0, 0, 0, 2, 2, 2, 2]),
    # fusion into the 20-class common space
    l1_cids2common_cids=_a([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 19]),
    l2_vehicle_cids2common_cids=_a([13, 14, 15, 16, 17, 18, 19]),
    l2_human_cids2common_cids=_a([11, 12, 19]),
    per_bbox_cids2common_cids=_a([18, 15, 13, 17, 16, 14, 11, 11, 11, 11, 11, 6, 7, 7, 19]),
)

_VISTAS = Taxonomy(
    name="vistas",
    # heads: L1 53, vehicle 12, human 5; common space: 66 (65 + void)
    num_l1_classes=53,
    num_vehicle_classes=12,
    num_human_classes=5,
    num_common_classes=66,
    cid_l1_vehicle=49,
    cid_l1_human=19,
    per_pixel_cids2l1_cids=_a(
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
         10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
         19, 19, 19, 20, 21, 22, 23, 24, 25, 26,
         27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
         37, 38, 39, 40, 41, 42, 43, 44, 45, 46,
         47, 48, 49, 49, 49, 49, 49, 49, 49, 49,
         49, 49, 49, 50, 51, 52]
    ),
    per_bbox_cids2l1_cids=_a([49, 49, 49, 49, 49, 49, 19, 19, 19, 19, 19, 52, 52, 52, 52]),
    # vehicle head cids: 0 bicycle, 1 boat, 2 bus, 3 car, 4 caravan, 5 motorcycle,
    # 6 on-rails, 7 other-vehicle, 8 trailer, 9 truck, 10 wheeled-slow, 11 void
    per_pixel_cids2vehicle_cids=_a(
        [11, 11, 11, 11, 11, 11, 11, 11, 11, 11,
         11, 11, 11, 11, 11, 11, 11, 11, 11, 11,
         11, 11, 11, 11, 11, 11, 11, 11, 11, 11,
         11, 11, 11, 11, 11, 11, 11, 11, 11, 11,
         11, 11, 11, 11, 11, 11, 11, 11, 11, 11,
         11, 11, 0, 1, 2, 3, 4, 5, 6, 7,
         8, 9, 10, 11, 11, 11]
    ),
    per_bbox_cids2vehicle_cids=_a([0, 2, 3, 5, 6, 9, 11, 11, 11, 11, 11, 11, 11, 11, 11]),
    # human head cids: 0 person, 1 bicyclist, 2 motorcyclist, 3 other rider, 4 void
    per_pixel_cids2human_cids=_a(
        [4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
         4, 4, 4, 4, 4, 4, 4, 4, 4, 0,
         1, 2, 3, 4, 4, 4, 4, 4, 4, 4,
         4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
         4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
         4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
         4, 4, 4, 4, 4, 4]
    ),
    per_bbox_cids2human_cids=_a([4, 4, 4, 4, 4, 4, 0, 0, 0, 0, 0, 4, 4, 4, 4]),
    l1_cids2common_cids=_a(
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
         10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
         23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
         33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
         43, 44, 45, 46, 47, 48, 49, 50, 51, 52,
         63, 64, 65]
    ),
    l2_vehicle_cids2common_cids=_a([52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 65]),
    l2_human_cids2common_cids=_a([19, 20, 21, 22, 65]),
    per_bbox_cids2common_cids=_a(
        [52, 54, 55, 57, 58, 61, 19, 19, 19, 19, 19, 48, 50, 50, 65]
    ),
)

_TAXONOMIES = {"cityscapes": _CITYSCAPES, "vistas": _VISTAS}


def get_taxonomy(per_pixel_dataset_name: str) -> Taxonomy:
    try:
        tax = _TAXONOMIES[per_pixel_dataset_name]
    except KeyError:
        raise ValueError(
            f"unknown per-pixel dataset {per_pixel_dataset_name!r}; "
            f"known: {sorted(_TAXONOMIES)}"
        ) from None
    tax.validate()
    return tax

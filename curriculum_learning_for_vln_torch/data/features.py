"""Panoramic image-feature loading.

A copy of ``curriculum_learning_for_vln_tpu/data/features.py`` (numpy only), kept
in the port so that it imports nothing of the JAX package.

Reads the reference's precomputed ResNet-152 TSV format
(`tasks/R2R-judy/src/utils/misc.py:245-279`): one row per
scan_viewpoint with base64 float32 (36, 2048) features, validated
against the 640x480 VFOV-60 camera constants.  Returns a dict usable as
the world compiler's ``feature_fn``.
"""
from __future__ import annotations

import base64
import csv
import sys
import time
from typing import Callable, Dict

import numpy as np

NUM_VIEWS = 36
MEAN_POOLED_DIM = 2048
IMAGE_W = 640
IMAGE_H = 480
VFOV = 60

_TSV_FIELDS = ["scanId", "viewpointId", "image_w", "image_h", "vfov", "features"]


def read_feature_tsv(path: str, views: int = NUM_VIEWS) -> Dict[str, np.ndarray]:
    """Load `<scan>_<viewpoint>` -> (views, D) float32 features."""
    csv.field_size_limit(sys.maxsize)
    features: Dict[str, np.ndarray] = {}
    start = time.time()
    with open(path) as f:
        reader = csv.DictReader(f, delimiter="\t", fieldnames=_TSV_FIELDS)
        for item in reader:
            assert int(item["image_h"]) == IMAGE_H
            assert int(item["image_w"]) == IMAGE_W
            assert int(item["vfov"]) == VFOV
            long_id = item["scanId"] + "_" + item["viewpointId"]
            features[long_id] = np.frombuffer(
                base64.b64decode(item["features"].encode("ascii")), dtype=np.float32
            ).reshape((views, -1))
    print(f"Loaded {len(features)} viewpoint features from {path} in {time.time()-start:.1f}s")
    return features


def feature_fn_from_dict(features: Dict[str, np.ndarray]) -> Callable[[str, str], np.ndarray]:
    return lambda scan, viewpoint: features[f"{scan}_{viewpoint}"]


def featurized_scans(features: Dict[str, np.ndarray]) -> set:
    return {key.split("_")[0] for key in features}

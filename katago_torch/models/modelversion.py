"""Model-version <-> input-feature-version mapping
(cpp/neuralnet/modelversion.{h,cpp}) — the port's own copy of
katago_tpu/models/modelversion.py.

Model file versions 3..17 map onto input-feature versions V3..V7, all
of which the port's featurizer (models/features.py) provides.
"""

from __future__ import annotations

OLDEST_MODEL_VERSION = 3
LATEST_MODEL_VERSION = 17
OLDEST_INPUTS_VERSION = 3
LATEST_INPUTS_VERSION = 7

_SPATIAL = {3: 22, 4: 22, 5: 13, 6: 22, 7: 22}
_GLOBAL = {3: 14, 4: 14, 5: 12, 6: 16, 7: 19}


def get_inputs_version(model_version: int) -> int:
    """modelversion.cpp:35-49."""
    if 8 <= model_version <= 17:
        return 7
    if model_version == 7:
        return 6
    if model_version == 6:
        return 5
    if model_version == 5:
        return 4
    if model_version in (3, 4):
        return 3
    raise ValueError(f"unsupported model version {model_version}")


def get_num_spatial_features(model_version: int) -> int:
    return _SPATIAL[get_inputs_version(model_version)]


def get_num_global_features(model_version: int) -> int:
    return _GLOBAL[get_inputs_version(model_version)]

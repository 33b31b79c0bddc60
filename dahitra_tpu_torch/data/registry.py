"""Dataset registry (the reference's data_config.py:2-16).

Counterpart of dahitra_tpu/data/registry.py. Maps a dataset name to its
root directory and label transform; 'norm' divides label values by 255
(LEVIR masks store change as 255). Roots live under ``$DAHITRA_DATA_ROOT``
(default ``data`` in the working directory).
"""
from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class DatasetConfig:
    root_dir: str
    label_transform: str = "norm"


def _datasets() -> dict:
    root = os.environ.get("DAHITRA_DATA_ROOT", "data")
    return {
        "LEVIR": DatasetConfig(os.path.join(root, "LEVIR_CD"), "norm"),
        "quick_start": DatasetConfig(os.path.join(root, "LEVIR_CD"), "norm"),
        "xBD": DatasetConfig(os.path.join(root, "xbd"), "none"),
    }


def get_data_config(name: str) -> DatasetConfig:
    """The config of ``name``, with ``$DAHITRA_DATA_ROOT`` read at call
    time."""
    datasets = _datasets()
    if name not in datasets:
        raise KeyError(f"unknown dataset {name!r}; available: "
                       f"{sorted(datasets)}")
    return datasets[name]

"""Dataset name -> on-disk location catalog (reference: config/paths_catalog.py:3-27).

A copy of the JAX package's catalog, less its weight-download indirection,
which the port does not use.
"""

import os


class DatasetCatalog:
    DATA_DIR = os.environ.get("MONOFLEX_DATA_DIR", "./datasets")
    DATASETS = {
        "kitti_train": {"root": "kitti/training"},
        "kitti_test": {"root": "kitti/testing"},
        "kitti_demo": {"root": "kitti_demo"},
    }

    @staticmethod
    def get(name: str):
        if name not in DatasetCatalog.DATASETS:
            raise RuntimeError(f"Dataset not available: {name}")
        root = os.path.join(DatasetCatalog.DATA_DIR, DatasetCatalog.DATASETS[name]["root"])
        return dict(factory="KITTIDataset", args=dict(root=root))

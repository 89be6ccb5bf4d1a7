"""Host-side IO (counterpart of coloc_tpu.io): synthetic scenes, disk
ingest and calibration, CSV / PLY logs, SVG overlays, the live view."""

import numpy as np


def decimate_map_points(X, valid=None, max_points: int = 4096) -> np.ndarray:
    """The landmark-cloud policy of the live view: drop invalid landmarks,
    then keep every n-th so that at most ~max_points remain and one
    publish stays small. Host numpy (tensors are copied to the host)."""
    X = np.asarray(X)
    if valid is not None:
        X = X[np.asarray(valid)]
    if len(X) > max_points:
        X = X[:: len(X) // max_points + 1]
    return X

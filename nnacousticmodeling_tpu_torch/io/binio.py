"""Binary matrix (.lab) format shared with the native decoder.

A copy of the JAX package's ``io/binio.py`` (numpy only). Format, the
reference's Python writer ``scripts/util/kw_utils.py:4-22`` and C++
reader ``recog_src/source/data.cpp:23-64``:

    uint32 rows, uint32 cols, then rows*cols payload values row-major.

1-D arrays are written as a single column (cols=1); a file whose cols
field is 1 reads back as a 1-D array, as the reference loader does.
"""

from __future__ import annotations

import numpy as np


def save_bin(filename: str, x: np.ndarray) -> None:
    """Write an array in the 2xuint32-header binary matrix format."""
    x = np.ascontiguousarray(x)
    if x.ndim == 1:
        dims = np.array([x.shape[0], 1], dtype=np.uint32)
    elif x.ndim == 2:
        dims = np.array(x.shape, dtype=np.uint32)
    else:
        raise ValueError(f"save_bin expects 1-D or 2-D array, got shape "
                         f"{x.shape}")
    with open(filename, "wb") as fid:
        dims.tofile(fid)
        x.tofile(fid)


def load_bin(filename: str, dtype) -> np.ndarray:
    """Read an array from the binary matrix format. Files with a single
    column come back 1-D (kw_utils.py:17-20)."""
    with open(filename, "rb") as fid:
        dims = np.fromfile(fid, dtype=np.uint32, count=2)
        payload = np.fromfile(fid, dtype=dtype)
    if dims[1] > 1:
        return payload.reshape(int(dims[0]), int(dims[1]))
    return payload

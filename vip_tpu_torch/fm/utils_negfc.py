"""``find_nearest`` (port-owned copy of ``vip_tpu.fm.utils_negfc``, the
whole of that module)."""

import numpy as np

__all__ = ["find_nearest"]


def find_nearest(array, value, output="index", constraint=None, n=1):
    """Index and/or value of the ``n`` elements of ``array`` closest to
    ``value`` (vip_tpu utils_negfc.py:9). ``constraint``: None, 'ceil',
    'floor', 'ceil=' or 'floor=' keeps only the elements above / below
    (or equal to) ``value``."""
    array = np.asarray(array)
    if constraint is None:
        fm = np.abs(array - value)
        idx = np.argpartition(fm, n)[:n]
    elif "floor" in constraint or "ceil" in constraint:
        indices = np.arange(len(array), dtype=np.int32)
        fm = -(array - value) if "floor" in constraint else array - value
        keep = fm >= 0 if "=" in constraint else fm > 0
        crop_indices = indices[keep]
        fm = fm[keep]
        if len(fm) == 0:
            print("No indices match the constraint ({} w.r.t {:.2f})"
                  .format(constraint, value))
            raise ValueError("No indices match the constraint")
        nn = min(n, len(fm) - 1) if len(fm) > 1 else 0
        if nn == 0:
            idx = np.array([np.argmin(fm)])
        else:
            idx = np.argpartition(fm, nn)[:n]
        idx = crop_indices[idx]
    else:
        raise ValueError("Constraint not recognised")

    if n == 1:
        idx = idx[0]
    if output == "index":
        return idx
    elif output == "value":
        return array[idx]
    return array[idx], idx

"""Host memory guard (port of ``vip_tpu.config.mem``)."""

import os

__all__ = ["check_enough_memory", "get_available_memory"]


def get_available_memory(verbose=True):
    """Available host memory in bytes (from ``sysconf``, no psutil)."""
    avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    if verbose:
        total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        print("System total memory = {:.3f} GB".format(total / 1e9))
        print("System available memory = {:.3f} GB".format(avail / 1e9))
    return avail


def check_enough_memory(input_bytes, factor=1, raise_error=True, error_msg="",
                        verbose=True):
    """Check ``input_bytes`` against available host memory × ``factor``."""
    if input_bytes > factor * get_available_memory(verbose=verbose):
        if raise_error:
            raise RuntimeError(
                "Input is larger than available system memory" + error_msg)
        return False
    return True

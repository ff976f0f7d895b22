"""Wall-clock timing helpers (port of ``vip_tpu.config.timing``)."""

from datetime import datetime

from .utils_conf import sep

__all__ = ["time_ini", "timing"]


def time_ini(verbose=True):
    """Set (and optionally print) the start time."""
    start_time = datetime.now()
    if verbose:
        print(sep)
        print("Starting time: " + start_time.strftime("%Y-%m-%d %H:%M:%S"))
        print(sep)
    return start_time


def timing(start_time):
    """Print elapsed time since ``start_time``."""
    print("Running time:  " + str(datetime.now() - start_time))
    print(sep)

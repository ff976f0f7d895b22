"""Host and card memory guards (port of ``vip_tpu.config.mem``)."""

import os

import torch

__all__ = ["check_enough_memory", "get_available_memory", "get_available_hbm"]


def get_available_memory(verbose=True):
    """Available host memory in bytes (from ``sysconf``, no psutil)."""
    avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    if verbose:
        total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        print("System total memory = {:.3f} GB".format(total / 1e9))
        print("System available memory = {:.3f} GB".format(avail / 1e9))
    return avail


def get_available_hbm(device=None, verbose=False):
    """Free memory of a CUDA card in bytes (``torch.cuda.mem_get_info``;
    vip_tpu mem.py:22 read its accelerator's memory stats). ``device``
    defaults to the current CUDA device; a CPU device answers with the
    available host memory, as vip_tpu's CPU backend did."""
    if device is None:
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return get_available_memory(verbose=verbose)
    free, _ = torch.cuda.mem_get_info(device)
    if verbose:
        print("Device memory available = {:.3f} GB".format(free / 1e9))
    return free


def check_enough_memory(input_bytes, factor=1, raise_error=True, error_msg="",
                        verbose=True):
    """Check ``input_bytes`` against available host memory × ``factor``."""
    if input_bytes > factor * get_available_memory(verbose=verbose):
        if raise_error:
            raise RuntimeError(
                "Input is larger than available system memory" + error_msg)
        return False
    return True

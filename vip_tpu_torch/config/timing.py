"""Wall-clock timing and profiling helpers (port of
``vip_tpu.config.timing``)."""

from datetime import datetime

from .utils_conf import sep

__all__ = ["time_ini", "timing", "time_fin", "device_trace",
           "annotate_trace"]


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


def time_fin(start_time):
    """Return elapsed time since ``start_time`` as a string."""
    return str(datetime.now() - start_time)


class device_trace:
    """Profile a block with ``torch.profiler`` and write its trace to
    ``log_dir`` (vip_tpu timing.py:32 wraps ``jax.profiler``)::

        with device_trace("vip-trace") as tr:
            pca(cube, angs, ncomp=10)
        print(tr.profile.key_averages().table(sort_by="cuda_time_total"))

    The profiler records the host's operators, and the card's kernels when
    PyTorch has CUDA; the trace is Chrome trace JSON
    (``<host>_<pid>.<time>.pt.trace.json``), which TensorBoard and the
    Perfetto UI open. ``create_perfetto_link`` is kept for vip_tpu's
    signature and changes nothing: no link is made. ``profile`` is the
    ``torch.profiler.profile`` of the block."""

    def __init__(self, log_dir, create_perfetto_link=False):
        self.log_dir = log_dir
        self.create_perfetto_link = create_perfetto_link
        self.profile = None

    def __enter__(self):
        import torch

        self.profile = torch.profiler.profile(
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(self.log_dir)))
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        self.profile.__exit__(*exc)
        return False


def annotate_trace(name):
    """A named span inside a :class:`device_trace` block
    (``torch.profiler.record_function``; vip_tpu's
    ``jax.profiler.TraceAnnotation``)."""
    import torch

    return torch.profiler.record_function(name)

"""Runtime utilities (port of ``vip_tpu.config.utils_conf``): array
checks, the task map, chunks, progress bars, ``.npz`` persistence of the
objects, output redirection and the decorator of the objects' calculated
attributes."""

import os
import sys
from contextlib import contextmanager
from functools import wraps
from inspect import Parameter, signature
from os.path import exists

import numpy as np
import torch

sep = "-" * 80
_PACKAGE_VERSION = "0.1.0"  # vip_tpu_torch.__version__ (and vip_tpu's)

__all__ = ["sep", "check_array", "frame_or_shape", "iterable", "pool_map",
           "make_chunks", "Progressbar", "Saveable", "redirect_output",
           "vip_figsize", "vip_figdpi"]

vip_figsize = (8, 5)
vip_figdpi = 100


def check_array(input_array, dim, msg=None):
    """Check the dimensionality of an input array or tensor.

    ``dim`` may be an int or a tuple of accepted ndims; 1d inputs may be
    a list or tuple as well (vip_tpu utils_conf.py:46).
    """
    if msg is None:
        msg = "Input array"
    dims = (dim,) if isinstance(dim, (int, np.integer)) \
        else tuple(int(d) for d in dim)
    if 1 in dims and isinstance(input_array, (list, tuple)):
        input_array = np.asarray(input_array)
    if not isinstance(input_array, (np.ndarray, torch.Tensor)) \
            or input_array.ndim not in dims:
        dim_names = {1: "1d", 2: "2d", 3: "3d", 4: "4d"}
        wanted = " or ".join(dim_names.get(d, f"{d}d") for d in dims)
        raise TypeError(f"`{msg}` must be a {wanted} numpy ndarray or "
                        "torch tensor")
    return input_array


def frame_or_shape(data):
    """A 2d frame as it is (numpy or tensor), or a host frame of zeros for a
    shape tuple (vip_tpu utils_conf.py:82)."""
    if isinstance(data, tuple):
        return np.zeros(data)
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data)
    if data.ndim != 2:
        raise TypeError("`data` must be a frame or a shape tuple")
    return data


class _Iterable:
    """Marker of the ``pool_map`` arguments that vary from task to task."""

    def __init__(self, it):
        self.it = it


def iterable(v):
    """Mark ``v`` as the sequence ``pool_map`` maps over."""
    return _Iterable(v)


def pool_map(nproc, fkt, *args, msg=None, verbose=True,
             progressbar_single=False, **kwargs):
    """``fkt`` over the elements of the ``iterable``-marked arguments,
    the others passed whole, and ``kwargs`` to every call (vip_tpu
    utils_conf.py:108, which dropped them). The calls run one after
    another in this process: a forked worker cannot use the parent's CUDA
    context, and the heavy work of each call is on the card already.
    ``nproc`` is accepted and changes nothing, results included."""
    iterables = [a.it for a in args if isinstance(a, _Iterable)]
    if not iterables:
        return [fkt(*args, **kwargs)]
    if verbose and msg is not None:
        print(f"{msg} serially")
    return [fkt(*[a.it[i] if isinstance(a, _Iterable) else a for a in args],
                **kwargs)
            for i in range(len(iterables[0]))]


def pool_imap(nproc, fkt, *args, **kwargs):
    """Lazy :func:`pool_map`: yields the results one at a time."""
    for res in pool_map(nproc, fkt, *args, **kwargs):
        yield res


def make_chunks(l, n):
    """``l`` in ``n`` strided parts (vip_tpu utils_conf.py:172):
    make_chunks(range(13), 3) -> [[0, 3, 6, 9, 12], [1, 4, 7, 10],
    [2, 5, 8, 11]]."""
    l = list(l)
    return [l[i::n] for i in range(n)]


class Progressbar:
    """Progress bar with a selectable backend (vip_tpu utils_conf.py:184):
    'tqdm' (the default, ``Progressbar.set`` changes it), 'tqdm_notebook',
    'pyprind' or 'hide'. Wraps an iterable, or counts ``bar.update()``
    calls. Where the backend's package is missing it is the silent
    :class:`NoProgressbar`: the bar is display only."""

    backend = "tqdm"

    def __new__(cls, iterable=None, desc=None, total=None, leave=True,
                backend=None, verbose=True):
        if backend is None:
            backend = Progressbar.backend
        if not verbose:
            backend = "hide"
        if backend in ("tqdm", "tqdm_notebook"):
            try:
                if backend == "tqdm_notebook":
                    from tqdm.notebook import tqdm
                else:
                    from tqdm import tqdm
            except ImportError:
                return NoProgressbar(iterable=iterable)
            return tqdm(iterable=iterable, desc=desc, total=total,
                        leave=leave, ascii=True, ncols=80, file=sys.stdout,
                        bar_format="{l_bar}{bar}| {n_fmt}/{total_fmt} "
                                   "[{elapsed}<{remaining}{postfix}]")
        elif backend == "pyprind":
            try:
                from pyprind import ProgBar, prog_bar
            except ImportError:
                return NoProgressbar(iterable=iterable)
            ProgBar._adjust_width = lambda self: None  # constant width
            if iterable is None:
                return ProgBar(total, title=desc, stream=1)
            return prog_bar(iterable, title=desc, stream=1,
                            iterations=total)
        elif backend == "hide":
            return NoProgressbar(iterable=iterable)
        raise NotImplementedError("unknown backend")

    def set(b):
        """Set the default backend of every later bar."""
        Progressbar.backend = b


class NoProgressbar:
    """The :class:`Progressbar` interface with no output."""

    def __init__(self, iterable=None):
        self.iterable = iterable

    def __iter__(self):
        return self.iterable.__iter__()

    def __next__(self):
        return self.iterable.__next__()

    def __getattr__(self, key):
        if key == "iterable":  # not set yet (e.g. mid-unpickle)
            raise AttributeError(key)
        return getattr(self.iterable, key)

    def update(self):
        pass


class Saveable:
    """Mixin of compressed ``.npz`` persistence, in vip_tpu's file layout
    (utils_conf.py:214): one entry per name of ``_saved_attributes``, the
    tags ``_vip_object`` and ``_vip_version``, and an ``_item_<name>``
    marker for each value that is not an array. A tensor is written as its
    host numpy array, with no marker, so a file written by either package
    loads in the other. ``load`` puts the names of the class's
    ``_tensor_attributes`` that hold arrays on the device of
    :func:`vip_tpu_torch.set_device`, as tensors."""

    def save(self, filename: str):
        names = getattr(self, "_saved_attributes", None)
        if names is None:
            names = sorted(self.__dict__)
        entries = {"_vip_object": type(self).__name__,
                   "_vip_version": _PACKAGE_VERSION}
        for name in names:
            if not hasattr(self, name):
                continue
            value = getattr(self, name)
            if isinstance(value, torch.Tensor):
                value = value.detach().cpu().numpy()
            entries[name] = value
            if not isinstance(value, np.ndarray):
                entries["_item_" + name] = True
        np.savez_compressed(filename, **entries)
        return filename

    @classmethod
    def load(cls, filename: str):
        from .device import as_tensor

        filename = str(filename)
        if not filename.endswith(".npz") and not exists(filename):
            filename = filename + ".npz"
        with np.load(filename, allow_pickle=True) as f:
            if "_vip_object" not in f:
                raise RuntimeError(f"{filename} is not a saved VIP object")
            clsname = f["_vip_object"].item()
            if clsname != cls.__name__:
                raise RuntimeError(
                    f"File {filename} holds a {clsname}, not a "
                    f"{cls.__name__}; use {clsname}.load() instead")
            obj = cls.__new__(cls)
            for key in f.files:
                if key.startswith("_"):
                    continue
                value = f[key]
                if "_item_" + key in f.files:
                    # lists and tuples come back as arrays whose .item()
                    # raises: rebuild them with tolist()
                    value = value.item() if value.ndim == 0 \
                        else value.tolist()
                setattr(obj, key, value)
        for name in getattr(cls, "_saved_attributes", ()):
            if not hasattr(obj, name):
                setattr(obj, name, None)
        for name in getattr(cls, "_tensor_attributes", ()):
            value = getattr(obj, name, None)
            if isinstance(value, np.ndarray):
                setattr(obj, name, as_tensor(value))
        post = getattr(obj, "_post_load", None)
        if callable(post):
            post()             # e.g. recompute shape-derived attributes
        return obj


class SaveableEmpty:
    """Empty shell an object is restored into without its __init__."""


@contextmanager
def redirect_output(filename):
    """Append what is printed in the block to ``filename``."""
    old = sys.stdout
    with open(filename, "a") as f:
        sys.stdout = f
        try:
            yield
        finally:
            sys.stdout = old


def eval_func_tuple(f_args):
    """``f_args[0](*f_args[1:])``."""
    return f_args[0](*f_args[1:])


def algo_calculates_decorator(*calculated_attributes):
    """Mark the attributes a ``PostProc`` method calculates (vip_tpu
    utils_conf.py:287): the wrapper records the call and, with
    ``verbose=True``, lists what was just calculated."""

    def decorator(fkt):
        @wraps(fkt)
        def wrapper(self, *args, **kwargs):
            res = fkt(self, *args, **kwargs)
            all_kwargs = {k: v.default
                          for k, v in signature(fkt).parameters.items()
                          if v.default is not Parameter.empty}
            all_kwargs.update(kwargs)
            if not hasattr(self, "_called_calculators"):
                self._called_calculators = []
            self._called_calculators.append(fkt.__name__)
            if all_kwargs.get("verbose", False):
                self._show_attribute_help(fkt.__name__)
            return res

        wrapper._calculates = set(calculated_attributes)
        return wrapper

    return decorator


def print_precision(array, precision=3):
    """Print an array or tensor (as host numpy) with ``precision``
    digits."""
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu().numpy()
    with np.printoptions(precision=precision, suppress=True):
        print(np.asarray(array))


class FixedObj:
    """A value ``pool_map`` passes whole to every call."""

    def __init__(self, v):
        self.v = v


def repeat(*args):
    """``itertools.repeat`` of every argument."""
    import itertools as itt

    return [itt.repeat(a) for a in args]


def lines_of_code():
    """Print the number of source lines of each module of the package and
    their total."""
    path = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    loclist = []
    for pydir, _, pyfiles in os.walk(path):
        for pyfile in pyfiles:
            if pyfile != "__init__.py" and pyfile.endswith(".py"):
                total = os.path.join(pydir, pyfile)
                with open(total) as fh:
                    loclist.append((len(fh.read().splitlines()),
                                    os.path.relpath(total, path)))
    for count, filename in sorted(loclist):
        print(f"{count:05d} lines in {filename}")
    print(f"\nTotal: {sum(x[0] for x in loclist)} lines in ({path})")

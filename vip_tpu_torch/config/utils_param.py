"""Dataclass-parameter plumbing.

Port of ``vip_tpu.config.utils_param`` (VIP's cross-cutting API
convention, vip_hci/config/utils_param.py:12-166): every modern
algorithm takes ``(*all_args, **all_kwargs)``, splits the kwargs into a
``@dataclass`` params object plus a pass-through dict (``rot_options``),
accepts a pre-built params object under the ``algo_params`` key, and routes
parameters to inner functions by signature introspection.
"""

from collections import OrderedDict
from inspect import signature
from typing import Any, Callable

import numpy as np

KWARGS_EXCEPTIONS = ["param"]

__all__ = [
    "filter_duplicate_keys",
    "setup_parameters",
    "print_algo_params",
    "separate_kwargs_dict",
]


def filter_duplicate_keys(filter_item: Any, ref_item: Any, filter_in: bool = True):
    """Filter the keys of ``filter_item`` against those of ``ref_item``.

    If ``filter_in`` is True, *remove* the keys present in the reference;
    otherwise keep only those keys.
    """
    filter_dict = dict(filter_item) if isinstance(filter_item, dict) else dict(vars(filter_item))
    ref_dict = dict(ref_item) if isinstance(ref_item, dict) else dict(vars(ref_item))

    if filter_in:
        for key in set(filter_dict) & set(ref_dict):
            del filter_dict[key]
    else:
        filter_dict = {k: v for k, v in filter_dict.items() if k in ref_dict}
    return filter_dict


def setup_parameters(
    params_obj: object,
    fkt: Callable,
    as_list: bool = False,
    show_params: bool = False,
    **add_params,
):
    """Select from ``params_obj`` (plus ``add_params``) exactly the parameters
    that ``fkt`` accepts, by signature introspection."""
    wanted_params = OrderedDict(signature(fkt).parameters)
    if add_params:
        obj_params = filter_duplicate_keys(filter_item=params_obj, ref_item=add_params)
        all_params = {**obj_params, **add_params}
    else:
        all_params = dict(vars(params_obj))

    params_setup = OrderedDict(
        (param, all_params[param]) for param in wanted_params if param in all_params
    )

    if show_params:
        print(f"The following parameters will be used for the run of {fkt.__name__} :")
        print_algo_params(params_setup)

    if as_list:
        return list(params_setup.values())
    return params_setup


def print_algo_params(function_parameters: dict) -> None:
    """Print the parameters used for an algorithm run."""
    for key, value in function_parameters.items():
        if isinstance(value, (np.ndarray, list)):
            print(f"- {key} : np.ndarray or list (not shown)")
        else:
            print(f"- {key} : {value}")


def resolve_algo_params(params_class, all_args, all_kwargs):
    """One-stop unpack used by every algorithm entry point: split
    ``all_kwargs`` into dataclass params vs ``rot_options``, honor a
    pre-built params object passed under ``ALGO_KEY``, and instantiate
    the dataclass otherwise. Returns (algo_params, rot_options)."""
    from .paramenum import ALGO_KEY

    class_params, rot_options = separate_kwargs_dict(
        initial_kwargs=all_kwargs, parent_class=params_class)
    algo_params = rot_options.pop(ALGO_KEY, None)
    if algo_params is None:
        algo_params = params_class(*all_args, **class_params)
    return algo_params, rot_options


def separate_kwargs_dict(initial_kwargs: dict, parent_class: Any):
    """Split kwargs into (params accepted by ``parent_class``, the rest).

    The "rest" is typically the ``rot_options`` pass-through dict. A key is
    routed to the class when the class has a (default-valued) attribute of
    that name.
    """
    class_params = {}
    more_params = {}
    for key, value in initial_kwargs.items():
        if hasattr(parent_class, key) or key in KWARGS_EXCEPTIONS:
            class_params[key] = value
        else:
            more_params[key] = value
    return class_params, more_params

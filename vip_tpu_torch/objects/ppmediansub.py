"""PostProc wrapper for median subtraction (port of
``vip_tpu.objects.ppmediansub``, VIP's objects/ppmediansub.py)."""

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config.utils_conf import algo_calculates_decorator as calculates
from ..psfsub.medsub import MEDIAN_SUB_Params, median_sub
from ._builder import dataclass_builder
from .dataset import Dataset
from .postproc import PostProc

__all__ = ["MedianBuilder", "PPMedianSub"]


@dataclass
class PPMedianSub(PostProc, MEDIAN_SUB_Params):
    """Object wrapper of the port's ``median_sub`` (vip_tpu
    ppmediansub.py:19)."""

    full_output: bool = True
    _algo_name: str = "median_sub"
    cube_residuals: np.ndarray = None
    cube_residuals_der: np.ndarray = None

    @calculates("cube_residuals", "cube_residuals_der", "frame_final")
    def run(self, dataset: Optional[Dataset] = None,
            nproc: Optional[int] = None,
            full_output: Optional[bool] = None, **rot_options):
        """Run median subtraction on the dataset (vip_tpu
        ppmediansub.py:29)."""
        self.snr_map = None
        self._update_dataset(dataset)
        if self.mode == "annular" and self.dataset.fwhm is None:
            raise ValueError("`fwhm` has not been set")
        if nproc is not None:
            self.nproc = nproc
        if full_output is not None:
            self.full_output = full_output
        self._explicit_dataset()
        params_dict = self._create_parameters_dict(MEDIAN_SUB_Params)
        all_params = {"algo_params": self, **rot_options}
        res = median_sub(**all_params)
        self.cube_residuals, self.cube_residuals_der, self.frame_final = res
        if self.results is not None:
            self.results.register_session(params=params_dict,
                                          frame=self.frame_final,
                                          algo_name=self._algo_name)


MedianBuilder = dataclass_builder(PPMedianSub)

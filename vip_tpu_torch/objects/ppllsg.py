"""PostProc wrapper for LLSG (port of ``vip_tpu.objects.ppllsg``, VIP's
objects/ppllsg.py)."""

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config.utils_conf import algo_calculates_decorator as calculates
from ..psfsub.llsg import LLSG_Params, llsg
from ._builder import dataclass_builder
from .dataset import Dataset
from .postproc import PostProc

__all__ = ["LLSGBuilder", "PPLLSG"]


@dataclass
class PPLLSG(PostProc, LLSG_Params):
    """Object wrapper of the port's ``llsg`` (vip_tpu ppllsg.py:18)."""

    full_output: bool = True
    _algo_name: str = "llsg"
    frame_l: np.ndarray = None
    frame_s: np.ndarray = None
    frame_g: np.ndarray = None

    @calculates("frame_final", "frame_l", "frame_s", "frame_g")
    def run(self, dataset: Optional[Dataset] = None,
            nproc: Optional[int] = None,
            full_output: Optional[bool] = True, **rot_options):
        """Run LLSG (vip_tpu ppllsg.py:28)."""
        self.snr_map = None
        self._update_dataset(dataset)
        self._explicit_dataset()
        if nproc is not None:
            self.nproc = nproc
        if full_output is not None:
            self.full_output = full_output
        if self.dataset.fwhm is None:
            raise ValueError("`fwhm` has not been set")
        params_dict = self._create_parameters_dict(LLSG_Params)
        all_params = {"algo_params": self, **rot_options}
        res = llsg(**all_params)
        self.frame_l = res[3]
        self.frame_s = res[4]
        self.frame_g = res[5]
        self.frame_final = self.frame_s
        if self.results is not None:
            self.results.register_session(params=params_dict,
                                          frame=self.frame_final,
                                          algo_name=self._algo_name)


LLSGBuilder = dataclass_builder(PPLLSG)

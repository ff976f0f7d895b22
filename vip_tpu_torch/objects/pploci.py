"""PostProc wrapper for LOCI (port of ``vip_tpu.objects.pploci``, VIP's
objects/pploci.py)."""

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config.utils_conf import algo_calculates_decorator as calculates
from ..psfsub.loci import XLOCI_Params, xloci
from ._builder import dataclass_builder
from .dataset import Dataset
from .postproc import PostProc

__all__ = ["LOCIBuilder", "PPLOCI"]


@dataclass
class PPLOCI(PostProc, XLOCI_Params):
    """Object wrapper of the port's ``xloci`` (vip_tpu pploci.py:18)."""

    full_output: bool = True
    _algo_name: str = "xloci"
    cube_res: np.ndarray = None
    cube_der: np.ndarray = None

    @calculates("frame_final", "cube_res", "cube_der")
    def run(self, dataset: Optional[Dataset] = None,
            nproc: Optional[int] = None,
            full_output: Optional[bool] = None, **rot_options):
        """Run LOCI (vip_tpu pploci.py:27)."""
        self.snr_map = None
        self._update_dataset(dataset)
        if self.dataset.fwhm is None:
            raise ValueError("`fwhm` has not been set")
        self._explicit_dataset()
        if nproc is not None:
            self.nproc = nproc
        if full_output is not None:
            self.full_output = full_output
        params_dict = self._create_parameters_dict(XLOCI_Params)
        all_params = {"algo_params": self, **rot_options}
        res = xloci(**all_params)
        self.cube_res, self.cube_der, self.frame_final = res
        if self.results is not None:
            self.results.register_session(frame=self.frame_final,
                                          params=params_dict,
                                          algo_name=self._algo_name)


LOCIBuilder = dataclass_builder(PPLOCI)

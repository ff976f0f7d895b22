"""PostProc wrapper for FMMF (port of ``vip_tpu.objects.ppfmmf``, VIP's
objects/ppfmmf.py)."""

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config.utils_conf import algo_calculates_decorator as calculates
from ..invprob.fmmf import FMMF_Params, fmmf
from ._builder import dataclass_builder
from .dataset import Dataset
from .postproc import PostProc

__all__ = ["FMMFBuilder", "PPFMMF"]


@dataclass
class PPFMMF(PostProc, FMMF_Params):
    """Object wrapper of the port's ``fmmf`` (vip_tpu ppfmmf.py:18)."""

    _algo_name: str = "fmmf"
    snr_map: np.ndarray = None

    @calculates("frame_final", "snr_map")
    def run(self, dataset: Optional[Dataset] = None,
            nproc: Optional[int] = None):
        """Run FMMF (vip_tpu ppfmmf.py:25)."""
        self.snr_map = None
        self._update_dataset(dataset)
        if self.dataset.fwhm is None:
            raise ValueError("`fwhm` has not been set")
        self._explicit_dataset()
        if nproc is not None:
            self.nproc = nproc
        params_dict = self._create_parameters_dict(FMMF_Params)
        all_params = {"algo_params": self}
        res = fmmf(**all_params)
        self.frame_final, self.snr_map = res
        if self.results is not None:
            self.results.register_session(params=params_dict,
                                          frame=self.frame_final,
                                          snr_map=self.snr_map,
                                          algo_name=self._algo_name)

    def make_snrmap(self):
        """No-op: fmmf already produces the snr_map (vip_tpu
        ppfmmf.py:45)."""
        self.detection_map = self.snr_map


FMMFBuilder = dataclass_builder(PPFMMF)

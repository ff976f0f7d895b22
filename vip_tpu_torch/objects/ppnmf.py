"""PostProc wrapper for NMF full-frame and annular (port of
``vip_tpu.objects.ppnmf``, VIP's objects/ppnmf.py)."""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

import numpy as np

from ..config.utils_conf import algo_calculates_decorator as calculates
from ..psfsub.nmf_fullfr import NMF_Params, nmf
from ..psfsub.nmf_local import NMF_ANNULAR_Params, nmf_annular
from ._builder import dataclass_builder
from .dataset import Dataset
from .postproc import PostProc

__all__ = ["NMFBuilder", "PPNMF"]

DELTA_ANN_DEFAULT = (0.1, 1)
DELTA_FF_DEFAULT = 1


@dataclass
class PPNMF(PostProc, NMF_Params, NMF_ANNULAR_Params):
    """Object wrapper of the port's ``nmf`` / ``nmf_annular`` (vip_tpu
    ppnmf.py:23)."""

    delta_rot: Union[int, float, Tuple[float]] = DELTA_ANN_DEFAULT
    full_output: bool = True
    _algo_name: List[str] = field(
        default_factory=lambda: ["nmf", "nmf_annular"])
    nmf_reshaped: np.ndarray = None
    cube_residuals: np.ndarray = None
    cube_residuals_der: np.ndarray = None
    cube_residuals_resc: np.ndarray = None

    @calculates("nmf_reshaped", "cube_recon", "cube_residuals",
                "cube_residuals_der", "frame_final")
    def run(self, runmode: Optional[str] = "fullframe",
            dataset: Optional[Dataset] = None, nproc: Optional[int] = 1,
            verbose: Optional[bool] = None, **rot_options):
        """Run full-frame or annular NMF (vip_tpu ppnmf.py:38)."""
        self.snr_map = None
        self._update_dataset(dataset)
        if self.dataset.fwhm is None:
            raise ValueError("`fwhm` has not been set")
        self._explicit_dataset()
        if nproc is not None:
            self.nproc = nproc
        if verbose is not None:
            self.verbose = verbose
        all_params = {"algo_params": self, **rot_options}
        if runmode == "fullframe":
            if not isinstance(self.delta_rot, (int, float)):
                self.delta_rot = DELTA_FF_DEFAULT
            params_dict = self._create_parameters_dict(NMF_Params)
            res = nmf(**all_params)
            (self.nmf_reshaped, self.cube_recon, self.cube_residuals,
             self.cube_residuals_der, self.frame_final) = res
            if self.results is not None:
                self.results.register_session(params=params_dict,
                                              frame=self.frame_final,
                                              algo_name=self._algo_name[0])
        else:
            self.delta_rot = DELTA_ANN_DEFAULT
            params_dict = self._create_parameters_dict(NMF_ANNULAR_Params)
            res = nmf_annular(**all_params)
            (self.cube_residuals, self.cube_residuals_der, self.cube_recon,
             self.nmf_reshaped, self.frame_final) = res
            if self.results is not None:
                self.results.register_session(params=params_dict,
                                              frame=self.frame_final,
                                              algo_name=self._algo_name[1])


NMFBuilder = dataclass_builder(PPNMF)

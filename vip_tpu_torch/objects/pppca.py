"""PostProc wrapper for PCA in all its variants (port of
``vip_tpu.objects.pppca``, VIP's objects/pppca.py)."""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config.paramenum import Adimsdi, ReturnList, Runmode
from ..config.utils_conf import algo_calculates_decorator as calculates
from ..config.utils_param import setup_parameters
from ..psfsub.pca_fullfr import PCA_Params, pca
from ..psfsub.pca_local import PCA_ANNULAR_Params, pca_annular
from ..psfsub.utils_pca import pca_annulus, pca_grid
from ._builder import dataclass_builder
from .dataset import Dataset
from .postproc import PostProc

__all__ = ["PCABuilder", "PPPCA"]


@dataclass
class PPPCA(PostProc, PCA_Params, PCA_ANNULAR_Params):
    """Object wrapper of the PCA family: full-frame, annular, grid and
    single annulus (vip_tpu pppca.py:23). Each run mode forwards to the
    port's ``pca``, ``pca_annular``, ``pca_grid`` or ``pca_annulus`` with
    the dataset's tensors, and keeps what it returns."""

    _algo_name: List[str] = field(default_factory=lambda: [
        "pca", "pca_annular", "pca_grid", "pca_annulus"])
    cube_sig: np.ndarray = None
    cube_residuals: np.ndarray = None
    cube_residuals_der: np.ndarray = None
    full_output = True

    pcs: np.ndarray = None
    cube_residuals_per_channel: np.ndarray = None
    cube_residuals_per_channel_der: np.ndarray = None
    cube_residuals_resc: np.ndarray = None
    final_residuals_cube: np.ndarray = None
    medians: np.ndarray = None

    frames_final: np.ndarray = None
    range_pcs: Tuple[int] = None
    mode: str = "fullfr"
    fmerit: str = "mean"
    plot: bool = False
    save_plot: str = None
    exclude_negative_lobes: bool = False
    initial_4dshape: Tuple = None
    dataframe: object = None
    pc_list: List = None
    opt_number_pc: int = None

    annulus_width: float = None
    r_guess: float = None

    @calculates("frame_final", "cube_reconstructed", "cube_residuals",
                "cube_residuals_der", "pcs",
                "cube_residuals_per_channel",
                "cube_residuals_per_channel_der", "cube_residuals_resc",
                "final_residuals_cube", "medians", "dataframe",
                "opt_number_pc")
    def run(self, runmode: Optional[str] = Runmode.CLASSIC,
            dataset: Optional[Dataset] = None, nproc: Optional[int] = 1,
            verbose: Optional[bool] = True,
            full_output: Optional[bool] = True, **rot_options):
        """Run the selected PCA variant (vip_tpu pppca.py:62)."""
        self.snr_map = None
        self._update_dataset(dataset)
        if self.dataset.fwhm is None:
            raise ValueError("`fwhm` has not been set")
        self._explicit_dataset()
        self.full_output = full_output

        if runmode == Runmode.CLASSIC:
            params_dict = self._create_parameters_dict(PCA_Params)
            all_params = {"algo_params": self, **rot_options}
            res = pca(**all_params)
            self._find_pca_mode(res=res)
            if self.results is not None and self.frame_final is not None:
                self.results.register_session(
                    params=params_dict, frame=self.frame_final,
                    algo_name=self._algo_name[0])
        elif runmode == Runmode.ANNULAR:
            if self.nproc is None:
                self.nproc = nproc
            params_dict = self._create_parameters_dict(PCA_ANNULAR_Params)
            all_params = {"algo_params": self, **rot_options}
            res = pca_annular(**all_params)
            self.cube_residuals = res[0]
            self.cube_residuals_der = res[1]
            if isinstance(res[2], list):
                self.frames_final = res[2]
            else:
                self.frame_final = res[2]
            if self.results is not None and self.frame_final is not None:
                self.results.register_session(
                    params=params_dict, frame=self.frame_final,
                    algo_name=self._algo_name[1])
        elif runmode == Runmode.GRID:
            add_params = {"full_output": full_output, "verbose": verbose}
            func_params = setup_parameters(params_obj=self, fkt=pca_grid,
                                           **add_params)
            res = pca_grid(**func_params, **rot_options)
            if self.source_xy is not None and self.fwhm is not None:
                (self.cube_residuals, self.frame_final, self.dataframe,
                 self.opt_number_pc) = res
                if self.results is not None:
                    self.results.register_session(
                        params=func_params, frame=self.frame_final,
                        algo_name=self._algo_name[2])
            elif self.full_output:
                self.final_residuals_cube, self.pc_list = res
            else:
                self.final_residuals_cube = res
        elif runmode == Runmode.ANNULUS:
            add_params = {"angs": self.angle_list}
            func_params = setup_parameters(params_obj=self,
                                           fkt=pca_annulus, **add_params)
            res = pca_annulus(**func_params, **rot_options)
            self.frame_final = res
            if self.results is not None:
                self.results.register_session(
                    params=func_params, frame=self.frame_final,
                    algo_name=self._algo_name[3])
        else:
            raise ValueError("Invalid run mode selected.")

    def _find_pca_mode(self, res):
        """Identify the pca() return shape and unpack accordingly (vip_tpu
        pppca.py:128); the cube may be an array or a tensor, and ``ncomp``
        a numpy integer too (as ``EvalRoc`` sets it from the CEVR, where
        vip_tpu finds no mode and raises)."""
        conditions = {
            "cube": isinstance(self.cube, (np.ndarray, torch.Tensor)),
            "scale": self.scale_list is not None,
            "adimsdidouble": self.adimsdi == Adimsdi.DOUBLE,
            "adimsdisingle": self.adimsdi == Adimsdi.SINGLE,
            "ncompunit": isinstance(self.ncomp, (float, int, np.integer)),
            "ncompit": isinstance(self.ncomp, (tuple, list)),
            "source": self.source_xy is not None,
            "nosource": self.source_xy is None,
            "reforsource": self.cube_ref is not None
            or self.source_xy is None,
            "nobatch": self.batch is None,
            "batch": self.batch is not None,
            "cubeorscale": isinstance(self.cube, str)
            or self.scale_list is None,
        }
        pca_modes = {
            ReturnList.ADIMSDI_DOUBLE: conditions["cube"]
            and conditions["scale"] and conditions["adimsdidouble"],
            ReturnList.ADIMSDI_SINGLE_NO_GRID: conditions["cube"]
            and conditions["scale"] and conditions["adimsdisingle"]
            and conditions["ncompunit"],
            ReturnList.ADIMSDI_SINGLE_GRID_NO_SOURCE: conditions["cube"]
            and conditions["scale"] and conditions["adimsdisingle"]
            and conditions["ncompit"] and conditions["nosource"],
            ReturnList.ADIMSDI_SINGLE_GRID_SOURCE: conditions["cube"]
            and conditions["scale"] and conditions["adimsdisingle"]
            and conditions["ncompit"] and conditions["source"],
            ReturnList.ADI_FULLFRAME_GRID: conditions["cubeorscale"]
            and conditions["reforsource"] and conditions["nobatch"]
            and conditions["ncompit"],
            ReturnList.ADI_INCREMENTAL_BATCH: conditions["cubeorscale"]
            and conditions["reforsource"] and conditions["batch"],
            ReturnList.ADI_FULLFRAME_STANDARD: conditions["cubeorscale"]
            and conditions["reforsource"] and conditions["nobatch"]
            and conditions["ncompunit"],
            ReturnList.PCA_GRID_SN: conditions["cubeorscale"]
            and conditions["source"] and conditions["ncompit"],
            ReturnList.PCA_ROT_THRESH: conditions["cubeorscale"]
            and conditions["source"] and conditions["ncompunit"],
        }
        pca_mode = None
        for mode, state in pca_modes.items():
            if state:
                pca_mode = mode
                break

        if pca_mode == ReturnList.ADIMSDI_DOUBLE:
            self.frame_final, self.cube_residuals, \
                self.cube_residuals_der = res
        elif pca_mode == ReturnList.ADIMSDI_SINGLE_NO_GRID:
            self.frame_final, self.cube_residuals, _ = res
        elif pca_mode == ReturnList.ADIMSDI_SINGLE_GRID_NO_SOURCE:
            self.final_residuals_cube, self.frame_final, _ = res
        elif pca_mode == ReturnList.ADIMSDI_SINGLE_GRID_SOURCE:
            self.final_residuals_cube, self.pc_list = res
        elif pca_mode == ReturnList.ADI_FULLFRAME_GRID:
            if self.cube.ndim == 4:
                self.frames_final, self.pc_list, _ = res
            else:
                self.frames_final, self.pc_list = res
        elif pca_mode == ReturnList.ADI_INCREMENTAL_BATCH:
            if self.cube.ndim == 4:
                self.frame_final, self.pcs, self.medians, _ = res
            else:
                self.frame_final, self.pcs, self.medians = res
        elif pca_mode == ReturnList.ADI_FULLFRAME_STANDARD:
            if self.cube.ndim == 4:
                (self.frame_final, self.pcs, self.cube_reconstructed,
                 self.cube_residuals, self.cube_residuals_der, _) = res
            else:
                (self.frame_final, self.pcs, self.cube_reconstructed,
                 self.cube_residuals, self.cube_residuals_der) = res
        elif pca_mode == ReturnList.PCA_GRID_SN:
            if self.cube.ndim == 4:
                (self.final_residuals_cube, self.frame_final, _,
                 self.opt_number_pc) = res
            else:
                self.final_residuals_cube, self.frame_final, _ = res
        elif pca_mode == ReturnList.PCA_ROT_THRESH:
            if self.cube.ndim == 4:
                (self.frame_final, self.cube_reconstructed,
                 self.cube_residuals, self.cube_residuals_der, _) = res
            else:
                (self.frame_final, self.cube_reconstructed,
                 self.cube_residuals, self.cube_residuals_der) = res
        else:
            raise RuntimeError("No PCA mode could be identified.")


PCABuilder = dataclass_builder(PPPCA)

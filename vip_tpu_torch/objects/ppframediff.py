"""PostProc wrapper for frame differencing (port of
``vip_tpu.objects.ppframediff``, VIP's objects/ppframediff.py)."""

from dataclasses import dataclass
from typing import Optional

from ..config.utils_conf import algo_calculates_decorator as calculates
from ..psfsub.framediff import FRAME_DIFF_Params, frame_diff
from ._builder import dataclass_builder
from .dataset import Dataset
from .postproc import PostProc

__all__ = ["FrameDiffBuilder", "PPFrameDiff"]


@dataclass
class PPFrameDiff(PostProc, FRAME_DIFF_Params):
    """Object wrapper of the port's ``frame_diff`` (vip_tpu
    ppframediff.py:17)."""

    full_output: bool = True
    _algo_name: str = "frame_diff"

    @calculates("frame_final")
    def run(self, dataset: Optional[Dataset] = None,
            nproc: Optional[int] = 1,
            full_output: Optional[bool] = True, **rot_options):
        """Run frame differencing (vip_tpu ppframediff.py:25)."""
        self.snr_map = None
        self._update_dataset(dataset)
        if self.dataset.fwhm is None:
            raise ValueError("`fwhm` has not been set")
        if nproc is not None:
            self.nproc = nproc
        if full_output is not None:
            self.full_output = full_output
        self._explicit_dataset()
        params_dict = self._create_parameters_dict(FRAME_DIFF_Params)
        all_params = {"algo_params": self, **rot_options}
        self.frame_final = frame_diff(**all_params)
        if self.results is not None:
            self.results.register_session(params=params_dict,
                                          frame=self.frame_final,
                                          algo_name=self._algo_name)


FrameDiffBuilder = dataclass_builder(PPFrameDiff)

"""Core classes for object-oriented post-processing: Session, PPResult and
PostProc (port of ``vip_tpu.objects.postproc``, VIP's
objects/postproc.py). A session's frame and S/N map are what the
algorithm returned (tensors on the device); the parameters kept with it
hold no array or tensor, and the FITS file holds host copies."""

import pickle
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..config.utils_conf import algo_calculates_decorator as calculates
from ..config.utils_param import print_algo_params
from ..fits import (dict_to_fitsheader, fitsheader_to_dict, open_fits,
                    write_fits)
from ..metrics.snr_source import significance, snr, snrmap
from ..var.coords import frame_center
from .dataset import Dataset, _host

__all__ = ["PostProc", "PPResult", "ALL_SESSIONS", "LAST_SESSION"]

PROBLEMATIC_ATTRIBUTE_NAMES = ["_repr_html_", "_estimator_html_repr",
                               "_doc_link_template"]
LAST_SESSION = -1
ALL_SESSIONS = -2
ALL_FITS = -2
DATASET_PARAM = "dataset"
EXPLICIT_PARAMS = {
    "cube": "cube",
    "angle_list": "angles",
    "fwhm": "fwhm",
    "cube_ref": "cuberef",
    "scale_list": "wavelengths",
    "psf": "psfn",
}
PREFIX = "postproc_"


@dataclass
class Session:
    """One run of a PostProc object: parameters, frame and S/N map
    (vip_tpu postproc.py:38)."""

    parameters: dict
    frame: object
    snr_map: object
    algo_name: str


@dataclass
class PPResult:
    """Container of post-processing sessions (vip_tpu postproc.py:49)."""

    sessions: List = field(default_factory=lambda: [])

    def __init__(self, load_from_path: str = None):
        self.sessions = []
        if load_from_path is not None:
            self.fits_to_results(filepath=load_from_path)

    def register_session(self, frame, algo_name=None, params=None,
                         snr_map=None):
        """Register a new session, or give the session of the same frame
        its S/N map (vip_tpu postproc.py:60). Frames compare as host
        copies; arrays and tensors are left out of the parameters, which
        go to FITS headers."""
        for session in self.sessions:
            if tuple(session.frame.shape) == tuple(frame.shape):
                if snr_map is not None and np.allclose(
                        np.abs(_host(session.frame)), np.abs(_host(frame)),
                        atol=1e-3):
                    session.snr_map = snr_map
                    return
        if params is None:
            params = {}
        filter_params = {key: params[key] for key in params
                         if not isinstance(params[key],
                                           (np.ndarray, torch.Tensor))}
        self.sessions.append(Session(parameters=filter_params, frame=frame,
                                     snr_map=snr_map,
                                     algo_name=algo_name))

    def show_session_results(self, session_id=LAST_SESSION, label=True):
        """Print parameters and plot frames of session(s) (vip_tpu
        postproc.py:78)."""
        if not self.sessions:
            raise AttributeError("No session was registered yet. Please "
                                 "register a session with the function "
                                 "`register_session`.")
        if isinstance(session_id, list):
            if all(isinstance(s_id, int) for s_id in session_id):
                for s_id in session_id:
                    self._show_single_session(s_id, label)
        elif session_id == ALL_SESSIONS:
            for s_id, _ in enumerate(self.sessions):
                self._show_single_session(s_id, label)
        elif session_id in range(ALL_SESSIONS + 1, len(self.sessions)):
            self._show_single_session(session_id, label)
        else:
            raise ValueError("Given session ID isn't an integer. Please "
                             "give an integer or a list of integers "
                             "(includes constant values such as "
                             "ALL_SESSIONS or LAST_SESSION).")

    def results_to_fits(self, filepath):
        """Save all sessions to a multi-extension FITS file, each frame
        (with its S/N map) a host copy (vip_tpu postproc.py:100)."""
        if not self.sessions:
            raise AttributeError("No session was registered yet. Please "
                                 "register a session with the function "
                                 "`register_session`.")
        images = []
        headers = []
        for session in self.sessions:
            if session.snr_map is not None:
                cube = np.stack((_host(session.frame),
                                 _host(session.snr_map)), axis=0)
            else:
                cube = _host(session.frame)
            images.append(cube)
            session.parameters["algo_name"] = session.algo_name
            prefix_dict = {PREFIX + key: value
                           for key, value in session.parameters.items()}
            headers.append(dict_to_fitsheader(prefix_dict))
        write_fits(fitsfilename=filepath, array=tuple(images),
                   header=tuple(headers))
        print(f"Results saved successfully to {filepath} !")

    def fits_to_results(self, filepath, session_id=ALL_FITS):
        """Load sessions from a FITS file (vip_tpu postproc.py:123): the
        frames are what ``open_fits`` returns (host numpy)."""
        data, header = open_fits(fitsfilename=filepath, n=session_id,
                                 header=True, verbose=False)
        self.sessions = []
        if session_id == ALL_FITS:
            for index, element in enumerate(data):
                parameters, algo_name = fitsheader_to_dict(
                    initial_header=header[index], sort_by_prefix=PREFIX)
                if element.ndim == 3:
                    frame = element[0]
                    snr_map = element[1]
                else:
                    frame = element
                    snr_map = None
                self.register_session(frame=frame, algo_name=algo_name,
                                      params=parameters, snr_map=snr_map)
        else:
            parameters, algo_name = fitsheader_to_dict(
                initial_header=header, sort_by_prefix=PREFIX)
            if data.ndim == 3:
                frame = data[0]
                snr_map = data[1]
            else:
                frame = data
                snr_map = None
            self.register_session(frame=frame, algo_name=algo_name,
                                  params=parameters, snr_map=snr_map)

    def _show_single_session(self, session_id, label=True):
        """Display one session, host copies (vip_tpu postproc.py:152)."""
        if session_id == LAST_SESSION:
            session_label = "last session"
        else:
            session_label = "session n°" + str(session_id + 1)
        print("Parameters used for the", session_label,
              f"(function used : {self.sessions[session_id].algo_name}) : ")
        print_algo_params(self.sessions[session_id].parameters)

        import matplotlib.pyplot as plt
        sess = self.sessions[session_id]
        if sess.snr_map is not None:
            fig, axes = plt.subplots(1, 2, figsize=(10, 4))
            axes[0].imshow(_host(sess.frame), origin="lower")
            axes[1].imshow(_host(sess.snr_map), origin="lower")
        else:
            plt.figure()
            plt.imshow(_host(sess.frame), origin="lower")
        plt.show()


@dataclass
class PostProc:
    """Base class for post-processing algorithm objects (vip_tpu
    postproc.py:175). ``run`` hands the dataset's tensors to the port's
    function and keeps what it returns (tensors on the device)."""

    dataset: Dataset = None
    verbose: bool = True
    results: PPResult = None
    frame_final: object = None
    signf: float = None

    def _explicit_dataset(self):
        """Copy dataset attributes onto self under algorithm-facing names
        (vip_tpu postproc.py:185)."""
        for self_name, data_name in EXPLICIT_PARAMS.items():
            dataset_value = getattr(self.dataset, data_name)
            setattr(self, self_name, dataset_value)

    def _create_parameters_dict(self, parent_class):
        """Dict of the parameters on self that belong to parent_class
        (vip_tpu postproc.py:192)."""
        params_dict = {}
        for attr_name in vars(self):
            if hasattr(parent_class, attr_name):
                params_dict[attr_name] = getattr(self, attr_name)
        return params_dict

    def print_parameters(self):
        """Print the object's parameters, arrays and tensors by their kind
        only (vip_tpu postproc.py:201)."""
        for key, value in self.__dict__.items():
            if isinstance(value, np.ndarray):
                print(f"{key} : numpy ndarray (not shown)")
            elif isinstance(value, torch.Tensor):
                print(f"{key} : torch tensor (not shown)")
            else:
                print(f"{key} : {value}")

    def compute_significance(self, source_xy=None):
        """Gaussian-equivalent significance of a detection (vip_tpu
        postproc.py:209)."""
        if self.snr_map is None:
            self.make_snrmap()
        snr_sig = snr(self.frame_final, source_xy=source_xy,
                      fwhm=self.fwhm)
        center_y, center_x = frame_center(self.snr_map)
        radius = np.sqrt((center_y - source_xy[1])**2 +
                         (center_x - source_xy[0])**2)
        self.signf = significance(snr_sig, radius, self.fwhm,
                                  student_to_gauss=True)
        print(r"{:.1f} sigma detection".format(self.signf))

    def _update_dataset(self, dataset=None):
        """Use a dataset passed to run(), resetting previous results
        (vip_tpu postproc.py:223)."""
        if dataset is not None:
            print("A new dataset was provided to run, all previous results "
                  "were cleared.")
            self.dataset = dataset
            self._reset_results()
        elif self.dataset is None:
            raise AttributeError("No dataset was specified ! Please give a "
                                 "valid dataset inside the builder of the "
                                 "associated algorithm or inside the "
                                 "`run()` function.")
        else:
            print("No changes were made to the dataset.")

    def get_params_from_results(self, session_id):
        """Load a previously saved configuration onto the object (vip_tpu
        postproc.py:239)."""
        if self.results is None:
            raise AttributeError("No results were saved yet ! Please give "
                                 "the object a PPResult instance and run "
                                 "the object at least once.")
        res = self.results.sessions
        if session_id > len(res) or res == []:
            raise ValueError(
                f"ID is higher than the current number of sessions "
                f"registered. There are {len(res)} saved now.")
        if res[session_id].algo_name not in self._algo_name:
            raise ValueError("The function used for that session does not "
                             "match your object. Please choose a session "
                             "with a corresponding function.")
        for key, value in res[session_id].parameters.items():
            setattr(self, key, value)
        print("Configuration loaded :")
        print_algo_params(res[session_id].parameters)

    def _get_calculations(self):
        """Map calculated attribute -> producing method (vip_tpu
        postproc.py:260)."""
        calculations = {}
        for element in vars(type(self)):
            if element in PROBLEMATIC_ATTRIBUTE_NAMES:
                continue
            try:
                for k in getattr(getattr(self, element), "_calculates",
                                 []):
                    calculations[k] = element
            except (AttributeError, TypeError):
                pass
        return calculations

    def _reset_results(self):
        """Delete results produced by earlier runs (vip_tpu
        postproc.py:275)."""
        for attr in self._get_calculations():
            try:
                delattr(self, attr)
            except AttributeError:
                pass

    def __getattr__(self, name):
        """Informative error for not-yet-calculated attributes (vip_tpu
        postproc.py:284)."""
        if name.startswith("_") or name in ("_get_calculations",
                                            "_calculations_cache"):
            raise AttributeError(
                f"'{type(self).__name__}' object has no attribute "
                f"'{name}'")
        calculations = self._get_calculations()
        if name in calculations:
            raise AttributeError(
                f"The {name} was not calculated yet. Call "
                f"{calculations[name]} first.")
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def _show_attribute_help(self, function_name):
        """List attributes just calculated / still available (vip_tpu
        postproc.py:300)."""
        calculations = self._get_calculations()
        print("These attributes were just calculated:")
        for attr, func in calculations.items():
            if hasattr(self, attr) and function_name == func:
                print(f"\t{attr}")
        not_calculated_yet = [
            (a, f) for a, f in calculations.items()
            if (f not in getattr(self, "_called_calculators", [])
                and not hasattr(self, a))]
        if len(not_calculated_yet) > 0:
            print("The following attributes can be calculated now:")
            for attr, func in not_calculated_yet:
                print(f"\t{attr}\twith .{func}()")

    @calculates("snr_map", "detection_map")
    def make_snrmap(self, approximated=False, plot=False,
                    known_sources=None, nproc=None, verbose=False):
        """S/N map of frame_final (vip_tpu postproc.py:318)."""
        if self.dataset.cube.ndim == 4:
            fwhm = np.mean(self.dataset.fwhm)
        else:
            fwhm = self.dataset.fwhm
        self.snr_map = snrmap(self.frame_final, fwhm, approximated,
                              plot=plot, known_sources=known_sources,
                              nproc=nproc, verbose=verbose)
        self.detection_map = self.snr_map
        if self.results is not None:
            self.results.register_session(frame=self.frame_final,
                                          snr_map=self.snr_map)

    def save(self, filename):
        """Pickle the object (vip_tpu postproc.py:333); its tensors keep
        their device."""
        with open(filename, "wb") as file:
            pickle.dump(self, file)

    @calculates("frame_final")
    def run(self):
        """Run the algorithm; subclasses must set ``frame_final``."""
        raise NotImplementedError

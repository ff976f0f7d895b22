"""DS9 window control (port of ``vip_tpu.vip_ds9``, VIP's vip_ds9.py).

A thin wrapper around pyds9 with VIP's ``Ds9Window`` API. pyds9 (and a
running DS9) is an optional, interactive dependency: the class imports
everywhere and raises ``ImportError`` at construction without pyds9.
Arrays and tensors go to DS9 as host numpy arrays.
"""

import numpy as np

__all__ = ["Ds9Window"]


def _require_pyds9():
    try:
        import pyds9
        return pyds9
    except ImportError as exc:
        raise ImportError(
            "pyds9 (and a DS9 installation) is required for Ds9Window. "
            "It is an optional interactive dependency not bundled with "
            "vip_tpu_torch.") from exc


def _host(array):
    """A host numpy copy of an array or a tensor."""
    if hasattr(array, "detach"):
        array = array.detach().cpu().numpy()
    return np.asarray(array)


class Ds9Window:
    """DS9 window (vip_tpu vip_ds9.py:22)."""

    def __init__(self, wait=10):
        pyds9 = _require_pyds9()
        self.window = pyds9.DS9(wait=wait)

    def clear_frames(self):
        """Clear all frames."""
        self.window.set("frame clear all")

    def create_frame(self):
        """Create a new frame."""
        self.window.set("frame new")

    def cmap(self, value=None):
        """Set or print the colormap."""
        if value is not None:
            self.window.set("cmap {}".format(value))
        else:
            print(self.window.get("cmap"))

    def crosshair_get(self):
        """The crosshair's coordinates."""
        return self.window.get("crosshair")

    def crosshair_set(self, x=None, y=None):
        """Put the crosshair at (x, y), or enter crosshair mode."""
        if x is not None and y is not None:
            self.window.set("crosshair {} {} physical".format(x, y))
        else:
            self.window.set("mode crosshair")

    def delete_frame(self, all_frames=False):
        """Delete the current frame, or all of them."""
        if all_frames:
            self.window.set("frame delete all")
        else:
            self.window.set("frame delete")

    def display(self, *arrays, **kwargs):
        """Display arrays or tensors, one frame each, as host numpy
        (``keep_prev=True`` keeps the frames shown before)."""
        keep_prev = kwargs.get("keep_prev", False)
        if not keep_prev:
            self.clear_frames()
        for array in arrays:
            self.create_frame()
            self.window.set_np2arr(_host(array))
        self.tile()

    def get(self, paramlist):
        """Raw XPA get."""
        return self.window.get(paramlist)

    def lock(self, scale=True, colorbar=True, crosshair=True, slices=True):
        """Lock display properties across frames."""
        if scale:
            self.window.set("lock scale yes")
        if colorbar:
            self.window.set("lock colorbar yes")
        if crosshair:
            self.window.set("lock crosshair image")
        if slices:
            self.window.set("lock slice image")

    def pan(self, x=None, y=None):
        """Pan to (x, y), or enter pan mode."""
        if x is not None and y is not None:
            self.window.set("pan to {} {}".format(x, y))
        else:
            self.window.set("mode pan")

    def rotate(self, value=None):
        """Rotate the display by ``value`` degrees, or open the rotate
        dialog."""
        if value is not None:
            self.window.set("rotate {}".format(value))
        else:
            self.window.set("rotate open")

    def scale(self, value=None):
        """Set or print the scale."""
        if value is not None:
            self.window.set("scale {}".format(value))
        else:
            print(self.window.get("scale"))

    def set(self, paramlist, data=None, data_func=-1):
        """Raw XPA set."""
        self.window.set(paramlist, data, data_func)

    def tile(self, mode="column"):
        """Tile the frames (``mode`` 'off' or 'no' stops tiling)."""
        if mode in ("off", "no"):
            self.window.set("tile no")
        else:
            self.window.set("tile yes")
            self.window.set("tile mode {}".format(mode))

    def unlock(self, scale=True, colorbar=True, crosshair=True,
               slices=True):
        """Unlock display properties."""
        if scale:
            self.window.set("lock scale no")
        if colorbar:
            self.window.set("lock colorbar no")
        if crosshair:
            self.window.set("lock crosshair none")
        if slices:
            self.window.set("lock slice none")

    def zoom(self, value="to fit"):
        """Zoom."""
        self.window.set("zoom {}".format(value))

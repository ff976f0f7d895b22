"""The fft-small rotation (ops/fft.rotate_fft_small_plain, the plain
version of CUDA kernel H3; its gate and route) against vip_tpu on the CPU.

- Float32 against vip_tpu's Pallas K3 ``rotate_fft_small_fused`` in
  interpret mode, at 3e-5 of max(|ref|, 1), the bound vip_tpu's own
  tests/test_pallas_shear.py:94 holds K3 to.
- Float64 against the float64 oracle of tests/test_pallas_shear.py:67-88
  (quadrant rot90 about (N/2, N/2), three complex numpy FFT shears): the
  same float64 FFTs in another library, 1e-10 of max(|ref|, 1).
- The gates of H2 and H3 as pure functions, and the fft-small route on the
  CPU, which stays packed as in vip_tpu whatever ``VIP_SMALL_SHEAR`` says.

H3 against its plain version on a card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch

import jax.numpy as jnp

from vip_tpu.ops import pipeline as jpipe
from vip_tpu.ops.pallas_shear import rotate_fft_small_fused as pallas_small
from vip_tpu_torch.ops import fft, pipeline, shear
from vip_tpu_torch.preproc import derotation

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


F32_TOL = 3e-5
F64_TOL = 1e-10


def _err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


def _oracle(frames, angles):
    """tests/test_pallas_shear.py:67-88, the float64 K3 oracle."""
    N = frames.shape[-1]
    kint = np.fft.fftfreq(N, 1.0 / N)
    q = np.arange(N, dtype=np.float64) - N / 2

    def sh(z, c, ax):
        ramp = np.outer(q, kint) / N if ax == 2 else np.outer(kint, q) / N
        ph = np.exp(-2j * np.pi * c * ramp)
        return np.fft.ifft(ph * np.fft.fft(z, axis=ax), axis=ax)

    ref = np.empty(frames.shape, np.float64)
    for i, ang in enumerate(angles % 360.0):
        d = ang % 90.0
        dangle = d - 90.0 if d > 45.0 else d
        k = int(round(ang / 90.0)) % 4 if ang > 45.0 else 0
        dangle = dangle if ang > 45.0 else ang
        ext = np.zeros((N + 1, N + 1))
        ext[:-1, :-1] = frames[i]
        fr = np.rot90(ext, k)[:-1, :-1].astype(np.complex128)
        a = np.tan(np.deg2rad(dangle) / 2)
        b = -np.sin(np.deg2rad(dangle))
        ref[i] = sh(sh(sh(fr[None], a, 2), b, 1), a, 2)[0].real
    return ref


@pytest.mark.parametrize("N,angles", [
    (256, [7.3, 130.2, 251.0]),
    (384, [44.2, 334.6]),
])
def test_small_plain_f32_vs_pallas_k3_interpret(N, angles):
    rng = np.random.default_rng(N)
    frames = rng.standard_normal((len(angles), N, N)).astype(np.float32)
    angles = np.asarray(angles, np.float32)
    ref = np.asarray(pallas_small(jnp.asarray(frames), jnp.asarray(angles),
                                  interpret=True))
    got = fft.rotate_fft_small_plain(torch.from_numpy(frames),
                                     torch.from_numpy(angles))
    assert got.dtype == torch.float32
    assert _err(got, ref) <= F32_TOL


@pytest.mark.parametrize("N", [128, 256, 384])
def test_small_plain_f64_vs_oracle(N):
    rng = np.random.default_rng(11 + N)
    angles = np.array([7.3, 44.2, 45.0, 90.0, 1.0, 334.6, 180.0, 225.5])
    frames = rng.standard_normal((len(angles), N, N))
    got = fft.rotate_fft_small_plain(torch.from_numpy(frames),
                                     torch.from_numpy(angles))
    assert got.dtype == torch.float64
    assert _err(got, _oracle(frames, angles)) <= F64_TOL


def test_small_fused_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.standard_normal((3, 128, 128)))
    angles = torch.tensor([10.0, 100.0, -70.0], dtype=torch.float64)
    before = shear.small_launches
    got = shear.rotate_fft_small_fused(frames, angles)
    assert shear.small_launches == before
    assert torch.equal(got, fft.rotate_fft_small_plain(frames, angles))


def test_small_gate():
    sup = shear.fused_small_supported
    for P in range(1, 17):
        assert sup(128 * P)
        assert sup(128 * P, torch.float32, torch.device("cuda"))
    assert not sup(128 * 17)                          # P > 16
    assert not sup(640 + 2)                           # not 128-foldable
    assert not sup(0)
    assert not sup(640, torch.float64)                # dtype
    assert not sup(640, torch.float32, "cpu")         # device


def test_exact_gate_mixed_radix_canvases():
    sup = shear.fused_shear_supported
    for y in (96, 160, 192, 224, 288):
        N = derotation._fft_rotate_geometry(y, y)[0]
        assert N % 128 == 0 and N & (N - 1) != 0
        assert sup(y, N)
    assert sup(64, 192)                               # 3 x 64
    assert not sup(64, 4096 + 128)                    # above 4096
    assert not sup(50, 200)                           # odd part 25


def test_mixed_radix_exact_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.standard_normal((2, 96, 96)))
    angles = torch.tensor([12.0, 200.0], dtype=torch.float64)
    before = shear.launches
    got = shear.rotate_exact(frames, angles)
    assert shear.launches == before
    ref = derotation.rotate_fft_pruned_batch(frames, angles)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("mode", ["fused", "packed"])
def test_small_route_on_cpu_stays_packed(monkeypatch, mode):
    """On the CPU the fft-small route is vip_tpu's packed path whatever
    VIP_SMALL_SHEAR says (vip_tpu/ops/pipeline.py:63-68), at float32 and
    float64."""
    monkeypatch.setenv("VIP_SMALL_SHEAR", mode)
    rng = np.random.default_rng(9)
    cube = rng.standard_normal((6, 32, 32))
    angles = np.linspace(0.0, 50.0, 6)
    before = shear.small_launches
    for dtype in (np.float32, np.float64):
        c = cube.astype(dtype)
        a = angles.astype(dtype)
        got = pipeline._derotate_frames(torch.from_numpy(c),
                                        torch.from_numpy(a), chunk=4,
                                        rot_mode="fft-small")
        ref = np.asarray(jpipe._derotate_frames(jnp.asarray(c), jnp.asarray(a),
                                                chunk=4,
                                                rot_mode="fft-small"))
        tol = F32_TOL if dtype == np.float32 else F64_TOL
        assert _err(got, ref) <= tol
    assert shear.small_launches == before

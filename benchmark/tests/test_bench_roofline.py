"""The yardstick's arithmetic against values worked out by hand."""

import math

import pytest

from yardstick import roofline


def test_canvas_of_vip_fft():
    # 512 -> 1.5x 768 -> 8/3 x 2048; 290 -> 435+1 = 436 -> 1163 -> 1162
    assert roofline.vip_fft_canvas(512) == (2048, 768)
    assert roofline.vip_fft_canvas(290) == (1162, 436)
    with pytest.raises(ValueError):
        roofline.vip_fft_canvas(101)


def test_shear_flop_and_bound():
    # 2·5·2048·11 + 6·2048 operations a line
    assert roofline.shear_flop(1, 2048) == 237568
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e9, 67e12) == pytest.approx(1.0)


def test_derotation_work_of_the_adi_cell():
    nbytes, flop = roofline.derotation_work(1000, 512)
    assert nbytes == 2 * 1000 * 512 * 512 * 4
    # 512 + 1 + 2048 + 512 lines of 2048 a frame
    assert flop == 237568 * 1000 * 3073
    # bound by operations: 7.30e11 / 67e12 = 10.896 ms
    assert roofline.bound_s(nbytes, flop) == pytest.approx(0.0108959, 1e-4)


def test_collapse_bytes():
    assert roofline.collapse_bytes(1000 * 512 * 512, 512 * 512) == \
        1001 * 512 * 512 * 4
    # the ADI cell's median: 1.05 GB over 3.35 TB/s
    t = roofline.bound_s(roofline.collapse_bytes(1000 * 512 ** 2, 512 ** 2),
                         0)
    assert t == pytest.approx(1001 * 512 ** 2 * 4 / 3.35e12)
    assert math.isclose(t * 1e3, 0.3133, rel_tol=1e-3)

"""annular_derotation_roofline: the least time the chip needs for VIP's
exact three-shear rotation of the frames each call of the resident
annular PCA's derotation was given, over the device time of the kernels
launched inside its range. Read as ``derotation_roofline`` reads its own
range: the work depends only on the frames' number and size."""

from yardstick.harness import load_module

read = load_module("metrics", "derotation_roofline").read

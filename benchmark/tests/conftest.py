"""The benchmark's own tests: the harness, its yardstick and its plain
references on the CPU at small sizes; tests marked ``cuda`` need the card
and skip without one."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.dirname(BENCH), BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture
def cpu_port(monkeypatch):
    """The port with numpy input on the CPU; tensors stay where they are."""
    import torch
    from vip_tpu_torch.config import device

    monkeypatch.setattr(device, "_device", torch.device("cpu"))


def tiny(cell_name, **config):
    """The cell ``cell_name`` of BENCHMARK.json cut to a CPU test's size."""
    from yardstick import harness

    cell = harness.load_cell(cell_name)
    sizes = ({"frames": 40, "frame_px": 32, "pool": 2}
             if cell.config.get("wavelengths_um") is None
             else {"frames": 10, "frame_px": 32, "pool": 1})
    cell.config.update(sizes, **config)
    return cell

"""Tests of the benchmark harness: ``python -m pytest portbench/tests -q``.

They run on the CPU at tiny rigs, through the harness's own code with the
port's plain twins; the one test marked ``cuda`` runs ``run.py`` on a
card and skips without one.
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (runs the benchmark on it)")


def tiny(name: str, cams: int = 2, h: int = 48, w: int = 64,
         lidar_pts: int = 256):
    """Cell ``name`` with its rig cut to ``cams`` cameras of ``w`` x ``h``
    and its lidar streams to ``lidar_pts`` points (the grid is kept)."""
    from pb import spec
    c = spec.cell(name)
    c.config["rig"].update(cameras=cams, height=h, width=w)
    f = c.config["fusion"]
    f.update(num_depth_streams=cams, depth_height=h, depth_width=w)
    if c.config.get("lidar"):
        c.config["lidar"]["points"] = lidar_pts
        f["max_points_per_sequence"] = 2 * lidar_pts
    return c


@pytest.fixture
def tiny_cell():
    return tiny


CELLS = ("hafen_link.stream", "hafen.stream")

"""The traffic mix's data drives the run: the open loop's pacing, the
stamps from ``stamp_hz`` and the scene's motion."""

import time

import numpy as np

from pb import drive
from pb.scene import Scene
from pb.spans import Spans

RIG = {"cameras": 2, "width": 64, "height": 48, "ring_slots": 8,
       "radius_m": 8.0, "height_m": 2.0, "tilt_rad": 0.3, "fov_deg": 60.0,
       "staged": 4}
STILL = {"sway_rad": 0.0, "sway_period_frames": 1, "shift_px": 0}


def test_portbench_open_loop_paces_at_the_stamp_rate(tiny_cell):
    cell = tiny_cell("hafen.stream")
    cell.traffic.update(loop="open", stamp_hz=25)
    scene = Scene.for_cell(5, cell, "cpu")
    system = drive.System(cell, scene, "cpu", Spans(), set())
    t0 = time.perf_counter()
    system.pace(t0)
    system.run(8)
    system.close()
    released = [d[1] for d in system.done]
    assert len(released) == 8
    assert np.allclose(np.diff(released), 1 / 25)
    assert released[0] == t0
    assert all(d[2] >= d[1] for d in system.done)
    assert time.perf_counter() - t0 >= 7 / 25
    assert system.late_s >= 0.0


def test_portbench_stamps_follow_stamp_hz():
    scene = Scene(3, RIG, {"streams": 1, "points": 16}, STILL, 10, "cpu")
    assert scene.stamp(25) == 10.0 + 25 / 10
    (_, sec0, nsec0), = scene.lidar(20)
    (_, sec1, nsec1), = scene.lidar(21)
    assert (sec1 - sec0) * 10 ** 9 + nsec1 - nsec0 == 100_000_000
    bench = Scene(3, RIG, None, STILL, 30, "cpu")
    assert bench.stamp(3) == 10.0 + 3 / 30


def test_portbench_motion_shifts_and_sways():
    still = Scene(9, RIG, None, STILL, 30, "cpu")
    moving = Scene(9, RIG, None, {"sway_rad": 0.2, "sway_period_frames": 8,
                                  "shift_px": 5}, 30, "cpu")
    for k in range(RIG["staged"]):
        assert np.array_equal(moving.depths[k],
                              np.roll(still.depths[k], 5 * k, axis=-1))
    assert np.array_equal(still.poses(0), still.poses(3))
    assert not np.allclose(moving.poses(0), moving.poses(2))
    assert np.allclose(moving.poses(1), moving.poses(9))

"""The moving scene a cell's traffic stages, made from ``--seed``.

A copy of ``chip_smoke.py``'s ``Scene`` (itself ``bench.py``'s scene):
a static background with fixed per-camera pattern noise, persistent holes
with churn, a blob circling in front of every camera, a swaying rig, and
two rotating lidar arcs. ``staged`` depth frames and arc sets are made
once and cycle; the rig pose and the stamps follow the frame index.

The configuration's ``rig`` and ``lidar`` entries size it; the traffic
mix's ``motion`` moves it and its ``stamp_hz`` stamps it:

- ``sway_rad``, ``sway_period_frames``: the rig's yaw swings by
  ``sway_rad`` with that period (``bench.py``: 0.02 rad, 60 frames);
- ``shift_px``: staged frame ``k``'s depth content is shifted ``k *
  shift_px`` columns, as a panning camera sees it (0: fixed content).

The scene lives on the host as numpy: the port takes its depth images
and lidar packets from host memory, and the plain reference is handed the
same arrays. Camera poses and intrinsics are computed here, not by the
port, so that the reference takes nothing the port made.
"""

from __future__ import annotations

import numpy as np

STAMP_START_S = 10.0


def _rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


def _rot_z(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)


def intrinsics(width: int, height: int, fov_deg: float) -> np.ndarray:
    """``[4]`` float32 (fx, fy, cx, cy): a horizontal field of view and a
    centred principal point."""
    fx = width / (2.0 * np.tan(np.deg2rad(fov_deg) / 2.0))
    return np.array([fx, fx, (width - 1) / 2.0, (height - 1) / 2.0],
                    dtype=np.float32)


class Scene:
    """``rig``: the configuration file's ``rig`` entry (cameras, width,
    height, ring_slots, radius_m, height_m, tilt_rad, fov_deg, staged);
    ``lidar``: its ``lidar`` entry (streams, points) or None; ``motion``
    and ``stamp_hz``: the traffic mix's. The depth images are drawn on
    ``device`` and kept on the host."""

    @classmethod
    def for_cell(cls, seed: int, cell, device="cpu") -> "Scene":
        return cls(seed, cell.config["rig"], cell.config.get("lidar"),
                   cell.traffic["motion"], cell.traffic["stamp_hz"], device)

    def __init__(self, seed: int, rig: dict, lidar: dict | None,
                 motion: dict, stamp_hz: float, device="cpu"):
        c, h, w = rig["cameras"], rig["height"], rig["width"]
        self.stamp_hz = float(stamp_hz)
        self.sway = float(motion["sway_rad"])
        self.sway_period = int(motion["sway_period_frames"])
        self.c, self.h, self.w = c, h, w
        self.staged = rig["staged"]
        self.ring_slots = rig["ring_slots"]
        self.radius = rig["radius_m"]
        self.height_m = rig["height_m"]
        self.tilt = rig["tilt_rad"]
        self.intr = intrinsics(w, h, rig["fov_deg"])
        import torch
        # the draws in a few large calls on the device, from the seed
        gen = torch.Generator(device).manual_seed(seed)
        dev = {"device": device, "generator": gen}
        x = torch.arange(w, device=device, dtype=torch.float64)[None, :]
        y = torch.arange(h, device=device, dtype=torch.float64)[:, None]
        base = 2500 + 200 * torch.sin(x / 150.0) + 150 * torch.cos(y / 120.0)
        fixed = base + 6.0 * torch.randn((c, h, w), dtype=torch.float64,
                                         **dev)
        holes = torch.rand((c, h, w), **dev) < 0.01
        k = torch.arange(self.staged, device=device, dtype=torch.float64)
        ang = 2 * np.pi * k / self.staged
        cx = (w * 0.5 + 6.0 * torch.cos(ang))[:, None, None]
        cy = (h * 0.5 + 6.0 * torch.sin(ang))[:, None, None]
        blob = 400 * torch.exp(-(((x - cx) / 25.0) ** 2
                                 + ((y - cy) / 20.0) ** 2))     # [K, H, W]
        noise = torch.randn((self.staged, c, h, w), dtype=torch.float64,
                            **dev)
        d = (fixed - blob[:, None] + noise).to(torch.int32)
        churn = torch.rand((self.staged, c, h, w), **dev) < 0.001
        d = torch.where(holes | churn, 0, d)
        shift = int(motion["shift_px"])
        if shift:
            d = torch.stack([torch.roll(d[j], j * shift, dims=-1)
                             for j in range(self.staged)])
        self.depths = d.to(torch.int16).cpu().numpy().view(np.uint16)
        self.arcs = []
        if lidar:
            n = lidar["points"]
            t = np.linspace(0, np.pi, n)
            for k in range(self.staged):
                rot = 2 * np.pi * k / self.staged
                arcs = [
                    np.stack([6 * np.cos(t + rot), 6 * np.sin(t + rot),
                              1 + 0.3 * np.sin(5 * t)], axis=-1),
                    np.stack([12 * np.cos(-t * 0.7 + rot),
                              12 * np.sin(-t * 0.7 + rot),
                              1.5 + 0 * t], axis=-1)]
                self.arcs.append([a.astype(np.float32)
                                  for a in arcs[:lidar["streams"]]])
        self._poses = [self._poses_at(f) for f in range(self.sway_period)]

    def _poses_at(self, f: int) -> np.ndarray:
        yaw0 = self.sway * np.sin(2 * np.pi * f / self.sway_period)
        out = np.empty((self.c, 4, 4), np.float32)
        for i in range(self.c):
            ang = i * 2 * np.pi / self.ring_slots + yaw0
            tf = np.eye(4, dtype=np.float32)
            tf[:3, :3] = _rot_z(ang + np.pi) @ _rot_x(-np.pi / 2 - self.tilt)
            tf[:3, 3] = (self.radius * np.cos(ang),
                         self.radius * np.sin(ang), self.height_m)
            out[i] = tf
        return out

    def depth(self, f: int) -> np.ndarray:
        """``[C, H, W]`` u16 depth of frame ``f``."""
        return self.depths[f % self.staged]

    def poses(self, f: int) -> np.ndarray:
        """``[C, 4, 4]`` float32 world <- camera of frame ``f`` (the crop
        frame is the world frame)."""
        return self._poses[f % self.sway_period]

    def lidar(self, f: int):
        """Frame ``f``'s lidar packets: ``[(points [N, 3] float32, sec,
        nsec)]`` (empty without lidar)."""
        # whole milliseconds apart within a second, as the 30 Hz bench
        # stamps them (33 ms)
        per_s = round(self.stamp_hz)
        sec = int(STAMP_START_S) + f // per_s
        nsec = (f % per_s) * (1000 // per_s) * 1_000_000
        return [(a, sec, nsec) for a in
                (self.arcs[f % self.staged] if self.arcs else [])]

    def stamp(self, f: int) -> float:
        """Frame ``f``'s stamp: ``stamp_hz`` spacing whatever the loop's
        rate."""
        return STAMP_START_S + f / self.stamp_hz

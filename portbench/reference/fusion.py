"""Plain reference of the fusion frame: what one frame's published cloud,
raw cloud and occupancy history must be.

Written from the semantics of the reference component
(``gpu_depthmap_fusion_component.cpp:92-515``) in plain torch, with no
kernel, cache, packet or pipelining, and nothing of the port imported:

1. each depth image unprojected through its pinhole intrinsics
   (``z = depth * scale``, ``x = (u - cx) / fx * z``) and transformed to
   the world and crop frames;
2. the flying-pixel filter: a pixel within ``max_distance`` of its camera
   is kept if, for every ring ``d = 1..size`` (and its 45-degree twin),
   its four neighbours are valid and inside the image and the surface
   normal ``cross(down - up, right - left)`` makes ``cos >= threshold``
   with the view ray;
3. the crop box;
4. the lidar sequences staged in the last ``aggregation_timespan``
   seconds, each filtered along its scan (a point goes when the direction
   to a neighbour is within ``threshold`` of its view ray);
5. per occupied cell the mean of its points' coordinates quantized to
   10/10/12 bits of the cell (summed exactly, then dequantized at the bin
   centre), in ascending cell order;
6. the occupancy history: ``lifetime`` at every cell occupied this frame,
   else one less than the frame before, never below 0.

The float32 arithmetic follows the reference shaders' order (products of
4-vectors summed pairwise, IEEE divisions by device tensors), so that the
port's outputs can be held to it bit for bit; ``dtype`` computes every
floating-point step in another type instead (the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .link import DepthLink, stage_lidar

QUANT_BITS = (10, 10, 12)


def _t(values, dev, dtype=torch.float32):
    return torch.tensor(values, dtype=dtype, device=dev)


class Grid:
    """The voxel grid: ``size[i] = max(1, ceil((upper - lower) / cell))``,
    linear index ``x + y * X + z * X * Y``."""

    def __init__(self, vmin, vmax, vsize):
        self.lower = tuple(min(a, b) for a, b in zip(vmin, vmax))
        self.upper = tuple(max(a, b) for a, b in zip(vmin, vmax))
        self.cell = tuple(vsize)
        self.size = tuple(max(1, int(math.ceil((u - lo) / c)))
                          for lo, u, c in zip(self.lower, self.upper,
                                              self.cell))
        self.steps = (1, self.size[0], self.size[0] * self.size[1])
        self.num_cells = self.size[0] * self.size[1] * self.size[2]

    def coord(self, xyz: torch.Tensor) -> torch.Tensor:
        """``[N, 3]`` integer grid coordinates, clamped to the border
        cells."""
        dt, dev = xyz.dtype, xyz.device
        f = torch.minimum(
            torch.clamp_min((xyz - _t(self.lower, dev, dt))
                            / _t(self.cell, dev, dt), 0.0),
            _t(self.size, dev, dt) - 1.0)
        u = torch.floor(f).to(torch.int64)
        return torch.minimum(torch.clamp_min(u, 0),
                             _t(self.size, dev, torch.int64) - 1)

    def index(self, xyz: torch.Tensor) -> torch.Tensor:
        u = self.coord(xyz)
        return u[:, 0] + u[:, 1] * self.steps[1] + u[:, 2] * self.steps[2]

    def corner(self, idx: torch.Tensor, dt) -> torch.Tensor:
        """Lower corners ``[N, 3]`` of linear cell indices."""
        gc = torch.stack([torch.remainder(
            torch.div(idx, self.steps[i], rounding_mode="floor"),
            self.size[i]) for i in range(3)], dim=-1)
        dev = idx.device
        return gc.to(dt) * _t(self.cell, dev, dt) + _t(self.lower, dev, dt)


def _transform(points: torch.Tensor, tfs: torch.Tensor) -> torch.Tensor:
    """``[C, N, 4]`` points by ``[C, 4, 4]`` transforms, each output the
    pairwise sum ``(T0 x + T1 y) + (T2 z + T3 w)``."""
    cols = [points[..., j:j + 1] * tfs[:, None, :, j] for j in range(4)]
    return (cols[0] + cols[1]) + (cols[2] + cols[3])


def unproject(depth: torch.Tensor, intr: torch.Tensor, tf_world, tf_crop,
              scale: float, dt):
    """``[C, H, W]`` integer depth -> camera, world and crop points
    ``[C, H*W, 4]`` (zero where the depth is a hole) and the mask."""
    c, h, w = depth.shape
    dev = depth.device
    d = depth.reshape(c, h * w).to(dt)
    mask = d > 0
    lin = torch.arange(h * w, dtype=torch.int32, device=dev)
    u = torch.remainder(lin, w).to(dt)[None, :]
    v = torch.div(lin, w, rounding_mode="floor").to(dt)[None, :]
    intr = intr.to(dt)
    z = d * _t(scale, dev, dt)
    x = (u - intr[:, 2:3]) / intr[:, 0:1] * z
    y = (v - intr[:, 3:4]) / intr[:, 1:2] * z
    cam = torch.stack([x, y, z, torch.ones_like(z)], dim=-1)
    m4 = mask[..., None]
    cam = torch.where(m4, cam, 0.0)
    world = torch.where(m4, _transform(cam, tf_world.to(dt)), 0.0)
    crop = torch.where(m4, _transform(cam, tf_crop.to(dt)), 0.0)
    return cam, world, crop, mask


def flying_pixels(cam: torch.Tensor, mask: torch.Tensor, h: int, w: int,
                  size: int, threshold: float, rot45: bool,
                  max_distance: float) -> torch.Tensor:
    """The flying-pixel mask ``[C, H*W]``; pixels within a ring's radius
    of the image border go."""
    c = cam.shape[0]
    dev, dt = cam.device, cam.dtype
    thr = _t(threshold, dev, dt)
    maxd = _t(max_distance, dev, dt)
    p = cam.reshape(c, h, w, 4)[..., :3]
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    m = mask.reshape(c, h, w)
    out = m & (((px * px + py * py) + pz * pz) <= maxd * maxd)
    vlen = torch.clamp_min(torch.sqrt((px * px + py * py) + pz * pz),
                           1e-30)
    vx, vy, vz = -px / vlen, -py / vlen, -pz / vlen
    yy = torch.arange(h, device=dev)[None, :, None]
    xx = torch.arange(w, device=dev)[None, None, :]

    def at(a, dy, dx):
        return torch.roll(a, shifts=(-dy, -dx), dims=(1, 2))

    def ring(d: int, diagonal: bool) -> torch.Tensor:
        offs = ({"up": (-d, -d), "down": (d, d), "left": (d, -d),
                 "right": (-d, d)} if diagonal else
                {"up": (-d, 0), "down": (d, 0), "left": (0, -d),
                 "right": (0, d)})
        ok = ((xx - d >= 0) & (xx + d <= w - 1)
              & (yy - d >= 0) & (yy + d <= h - 1)) & m
        nb = {}
        for name, (dy, dx) in offs.items():
            ok = ok & at(m, dy, dx)
            nb[name] = [at(q, dy, dx) for q in (px, py, pz)]
        a = [nb["down"][k] - nb["up"][k] for k in range(3)]
        b = [nb["right"][k] - nb["left"][k] for k in range(3)]
        n0 = a[1] * b[2] - a[2] * b[1]
        n1 = a[2] * b[0] - a[0] * b[2]
        n2 = a[0] * b[1] - a[1] * b[0]
        nlen = torch.clamp_min(torch.sqrt((n0 * n0 + n1 * n1) + n2 * n2),
                               1e-30)
        cos = (n0 / nlen * vx + n1 / nlen * vy) + n2 / nlen * vz
        return ok & (cos >= thr)

    for d in range(1, size + 1):
        out = out & ring(d, False)
        if rot45:
            out = out & ring(d, True)
    return out.reshape(c, h * w)


def in_box(xyz: torch.Tensor, lower, upper) -> torch.Tensor:
    dev, dt = xyz.device, xyz.dtype
    return torch.all((xyz >= _t(lower, dev, dt))
                     & (xyz <= _t(upper, dev, dt)), dim=-1)


def scan_filter(pts: torch.Tensor, size: int, threshold: float
                ) -> torch.Tensor:
    """The 1-D scan filter over one frame's staged points ``[N, 3]``:
    neighbour offsets ``{-1..size-2} U {1..size}`` within the staging."""
    n = pts.shape[0]
    dev, dt = pts.device, pts.dtype
    px, py, pz = pts[:, 0], pts[:, 1], pts[:, 2]
    idx = torch.arange(n, device=dev)
    thr = _t(threshold, dev, dt)
    norm = torch.sqrt((px * px + py * py) + pz * pz)
    out = norm >= 1e-3
    den = torch.clamp_min(norm, 1e-30)
    vx, vy, vz = -px / den, -py / den, -pz / den
    for d in sorted(set(range(-1, size - 1)) | set(range(1, size + 1))):
        if d == 0:
            continue
        inside = (idx + d >= 0) & (idx + d < n)
        dx = torch.roll(px, -d) - px
        dy = torch.roll(py, -d) - py
        dz = torch.roll(pz, -d) - pz
        dn = torch.clamp_min(torch.sqrt((dx * dx + dy * dy) + dz * dz),
                             1e-30)
        cos = torch.abs((dx / dn * vx + dy / dn * vy) + dz / dn * vz)
        out = out & ~(inside & (1.0 - cos < thr))
    return out


def cell_means(xyz: torch.Tensor, grid: Grid):
    """Ascending occupied cells ``[M]`` int64 and their mean points
    ``[M, 3]`` (in ``xyz``'s type) from the valid points ``xyz``."""
    dt, dev = xyz.dtype, xyz.device
    idx = grid.index(xyz)
    corner = grid.corner(idx, dt)
    cs = _t(grid.cell, dev, dt)
    q = torch.stack([torch.clamp(torch.floor(
        (xyz[:, a] - corner[:, a]) / cs[a] * float(1 << b)),
        0.0, float((1 << b) - 1)) for a, b in enumerate(QUANT_BITS)],
        dim=-1)
    cells, inv = torch.unique(idx, return_inverse=True)
    sums = torch.zeros((cells.shape[0], 3), dtype=torch.float64,
                       device=dev).index_add_(0, inv, q.double())
    cnt = torch.zeros((cells.shape[0],), dtype=torch.float64,
                      device=dev).index_add_(
        0, inv, torch.ones_like(inv, dtype=torch.float64))
    mean_q = sums.to(dt) / torch.clamp_min(cnt.to(dt)[:, None], 1.0)
    step = cs / _t(tuple(float(1 << b) for b in QUANT_BITS), dev, dt)
    return cells, grid.corner(cells, dt) + (mean_q + 0.5) * step


class Reference:
    """The reference over a cell's frames. ``cfg``: the configuration
    file's ``fusion`` fields; ``scene``: the harness's scene (depth,
    poses, intrinsics, lidar packets by frame); ``dtype``: the type of
    every floating-point step."""

    def __init__(self, cfg: dict, scene, device, dtype=torch.float32):
        if cfg["enable_radius_filter"] or not cfg["enable_voxel_filter"] \
                or not cfg["voxel_enable_average"] \
                or cfg["voxel_mean_mode"] not in ("auto", "rle", "packed"):
            raise ValueError("the reference averages quantized cell "
                             "coordinates, with no radius filter")
        self.cfg, self.scene, self.dev, self.dt = cfg, scene, device, dtype
        self.grid = Grid(cfg["voxel_min"], cfg["voxel_max"],
                         cfg["voxel_size"])
        self.link = DepthLink(cfg)
        self._depth = {}        # frame -> decoded depth, while needed
        self._lidar = {}        # frame -> staged sequences
        self._frames = {}       # frame -> (raw xyz, fused cells, means)
        self._staged = torch.from_numpy(
            scene.depths.astype(np.int32)).to(device)

    def _decoded(self, f: int) -> torch.Tensor:
        while self.link.frame <= f:
            g = self.link.frame
            self._depth[g] = self.link.next(
                self._staged[g % self.scene.staged])
            self._depth.pop(g - 16, None)
        return self._depth[f]

    def _staged_lidar(self, g: int):
        """Frame ``g``'s sequences: ``[(points [n, 3], kept [n], stamp
        ns)]`` as the link delivers them, filtered along the scan."""
        if g not in self._lidar:
            cfg = self.cfg
            step = float(cfg["lidar_link_quant_step"])
            if not cfg["lidar_link_delta"] or step <= 0:
                raise ValueError("the reference models the delta-coded "
                                 "lidar link only")
            stage_cap = cfg["max_points_per_sequence"]
            seqs = stage_lidar(
                self.scene.lidar(g), step,
                max(256, min(2048, stage_cap // 8)), stage_cap,
                max(1, cfg["num_point_sequences"] * 4))
            out = []
            if seqs:
                q = torch.from_numpy(np.concatenate([s[0] for s in seqs])
                                     ).to(self.dev, self.dt)
                xyz = q * step - 32768.0 * step
                kept = scan_filter(xyz, cfg["point_sequence_filter_size"],
                                   cfg["point_sequence_filter_threshold"])
                start = 0
                for qs, sec, nsec in seqs:
                    n = qs.shape[0]
                    out.append((xyz[start:start + n],
                                kept[start:start + n],
                                sec * 1_000_000_000 + nsec))
                    start += n
            self._lidar[g] = out
            self._lidar.pop(g - 64, None)
        return self._lidar[g]

    def _window(self, f: int):
        """The sequences of frames up to ``f`` that the rollbuffer holds
        after frame ``f``'s expiry, oldest first, and ``f``'s selection
        window ``(low, now)`` in ns."""
        now = int(round(self.scene.stamp(f) * 1e9))
        low = max(now - int(round(
            self.cfg["point_sequence_aggregation_timespan"] * 1e9)), 0)
        frames = []
        for g in range(f, -1, -1):
            seqs = [s for s in self._staged_lidar(g) if s[2] >= low]
            if not seqs:
                break
            frames.append(seqs)
        return [s for seqs in frames[::-1] for s in seqs], low, now

    def _selection(self, f: int) -> torch.Tensor:
        """World points ``[M, 3]`` of the lidar selection at frame ``f``
        (the move transforms are the identity), filtered and cropped."""
        cfg = self.cfg
        if not cfg["num_point_sequences"]:
            return torch.zeros((0, 3), dtype=self.dt, device=self.dev)
        held, low, now = self._window(f)
        # the buffer takes frame f's sequences beside what frame f - 1
        # kept; the reference models no dropped sequence
        kept_before = sum(s[0].shape[0] for s in self._window(f - 1)[0]) \
            if f else 0
        if kept_before + sum(s[0].shape[0] for s in self._staged_lidar(f)) \
                > cfg["rollbuffer_point_capacity"]:
            raise ValueError("the lidar window outgrows the rollbuffer")
        pts = [xyz[kept] for xyz, kept, t in held if low <= t <= now]
        if not pts:
            return torch.zeros((0, 3), dtype=self.dt, device=self.dev)
        xyz = torch.cat(pts)
        return xyz[in_box(xyz, cfg["crop_min"], cfg["crop_max"])]

    def frame(self, f: int):
        """``(raw xyz [N, 3], fused cells [M], fused means [M, 3])`` of
        frame ``f``: the raw cloud in the order the step emits it (depth
        pixels camera by camera, then the lidar selection)."""
        if f in self._frames:
            return self._frames[f]
        cfg, sc, dev, dt = self.cfg, self.scene, self.dev, self.dt
        depth = self._decoded(f)
        intr = torch.from_numpy(np.tile(sc.intr, (sc.c, 1))).to(dev)
        poses = torch.from_numpy(sc.poses(f)).to(dev)
        cam, world, crop, mask = unproject(depth, intr, poses, poses,
                                           cfg["depth_scale"], dt)
        if cfg["enable_flyingpixels_filter"]:
            mask = flying_pixels(
                cam, mask, sc.h, sc.w, cfg["flyingpixels_filter_size"],
                cfg["flyingpixels_filter_threshold"],
                cfg["flyingpixels_filter_enable_rot45"],
                cfg["flyingpixels_max_distance"])
        world = world.reshape(-1, 4)[:, :3]
        mask = mask.reshape(-1) & in_box(crop.reshape(-1, 4)[:, :3],
                                         cfg["crop_min"], cfg["crop_max"])
        raw = torch.cat([world[mask], self._selection(f)])
        cells, means = cell_means(raw, self.grid)
        self._frames[f] = (raw, cells, means)
        for g in [g for g in self._frames if g < f - 16]:
            del self._frames[g]
        return self._frames[f]

    def history(self, f: int) -> torch.Tensor:
        """The ``[num_cells]`` int32 occupancy history after frame ``f``."""
        life = self.cfg["voxel_occupancy_lifetime"]
        hist = torch.zeros((self.grid.num_cells,), dtype=torch.int32,
                           device=self.dev)
        for j in range(min(life, f + 1) - 1, -1, -1):
            cells = self.frame(f - j)[1]
            hist[cells] = life - j
        return hist

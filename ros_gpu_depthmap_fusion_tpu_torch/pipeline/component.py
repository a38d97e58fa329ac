"""Streaming component: the callback-driven host loop around the engine
(the JAX package's ``pipeline/component.py`` on the port's engine).

Equivalent of the reference's ROS layer ``GPUDepthmapFusionComponent``
(``src/gpu_depthmap_fusion_component.cpp``) with plain callables in place
of the message bus:

- :meth:`FusionComponent.callback_depthmap` /
  :meth:`~FusionComponent.callback_point_sequence` — the subscription
  callbacks (cpp:1047-1104, 991-1013), the depth streams synchronized by
  :class:`~.sync.ApproximateTimeSynchronizer`;
- resample decoupling — with ``cfg.resample_rate > 0`` arriving frames are
  stashed and :meth:`~FusionComponent.tick_resample` processes the latest
  (cpp:74-90, 1202-1210);
- live reconfig — :meth:`~FusionComponent.set_flying_pixel_config`, the
  reference's three ``in/Config/FilterFlyingPixels/*`` topics
  (cpp:970-990);
- publishers — ``on_points`` / ``on_mapping`` callables in place of
  ``out/Points`` / ``out/Viz`` (cpp:1197-1200);
- ``cfg.enable_debug_output`` — switches the tracer
  (:mod:`utils.profiling`) on while the component's callbacks run, and
  back to its earlier state after each, and prints its report of each
  frame after the frame (the reference's timing printout, cpp:466-515).

The device is explicit, as for the engine.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional

import numpy as np

from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
    FrameOutputs, FusionEngine)
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.sync import (
    ApproximateTimeSynchronizer, SlotConfig, Stamped)
from ros_gpu_depthmap_fusion_tpu_torch.utils import profiling


@dataclasses.dataclass
class DepthMessage:
    depth: np.ndarray
    intrinsics: PinholeIntrinsics
    tf_world_cam: np.ndarray
    tf_crop_cam: np.ndarray


def _traced(method):
    """Run ``method`` with the tracer on when the component's
    ``cfg.enable_debug_output`` is set, restoring the tracer's state
    after: other engines in the process are not traced for it."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        if not self.cfg.enable_debug_output:
            return method(self, *args, **kwargs)
        was = profiling.enabled()
        profiling.enable()
        try:
            return method(self, *args, **kwargs)
        finally:
            profiling.enable(was)
    return wrapper


class FusionComponent:
    def __init__(self, cfg: FusionConfig, device,
                 on_points: Optional[Callable[[FrameOutputs], None]] = None,
                 on_mapping: Optional[Callable] = None,
                 enable_mapping: bool = False,
                 sync_slop: float = 1.0 / 60.0):
        self.cfg = cfg
        self.device = device
        self.engine = FusionEngine(cfg, device, enable_mapping=enable_mapping)
        self.on_points = on_points
        self.on_mapping = on_mapping
        self.enable_mapping = enable_mapping
        slots = [SlotConfig(trigger=(i == 0), optional=(i != 0))
                 for i in range(cfg.num_depth_streams)]
        self.sync = ApproximateTimeSynchronizer(slots, slop=sync_slop)
        self.resample = cfg.resample_rate > 0
        self._stash: Optional[List[Optional[Stamped]]] = None
        self._stash_new = False
        self._tf_world_move = np.eye(4, dtype=np.float32)
        self._tf_crop_move = np.eye(4, dtype=np.float32)
        self.frames_processed = 0
        # per-slot CameraInfo (cpp:131-135); images arriving before the
        # slot's intrinsics are dropped (_component.cpp:118)
        self._camera_info: List[Optional[PinholeIntrinsics]] = (
            [None] * cfg.num_depth_streams)
        self.frames_skipped_no_intrinsics = 0

    # ------ subscriptions -------------------------------------------------
    def callback_camera_info(self, slot: int,
                             intrinsics: PinholeIntrinsics) -> None:
        """CameraInfo for a stream slot (``in/CameraInfo/N``,
        _component.cpp:131-135, 1398-1405): depth images on a slot are
        processed only once its intrinsics are known."""
        self._camera_info[slot] = intrinsics

    @_traced
    def callback_depthmap(self, slot: int, stamp: float,
                          depth_u16: np.ndarray,
                          intrinsics: Optional[PinholeIntrinsics] = None,
                          tf_world_cam: np.ndarray = None,
                          tf_crop_cam: Optional[np.ndarray] = None):
        """One depth image on a stream slot. Runs a frame when the sync
        policy fires (stashes it under resampling). An image on a slot
        with no intrinsics, given here or by :meth:`callback_camera_info`,
        is skipped (``_component.cpp:118``)."""
        if intrinsics is None:
            intrinsics = self._camera_info[slot]
        if intrinsics is None:
            self.frames_skipped_no_intrinsics += 1
            return None
        if tf_crop_cam is None:
            tf_crop_cam = tf_world_cam
        msg = DepthMessage(depth_u16, intrinsics, tf_world_cam, tf_crop_cam)
        with profiling.span("fusion.component.sync", self.engine.frame_id):
            dropped = self.sync.dropped
            tup = self.sync.push(slot, stamp, msg)
            profiling.count("fusion.component.sync_dropped",
                            self.sync.dropped - dropped)
            if tup is not None and self.resample:
                if self._stash_new:
                    profiling.count("fusion.component.stash_replaced")
                self._stash = tup
                self._stash_new = True
        if tup is None or self.resample:
            return None
        return self._process_tuple(tup, stamp)

    @_traced
    def callback_point_sequence(self, stamp: float, points_xyz: np.ndarray,
                                tf_move_sensor: Optional[np.ndarray] = None):
        """One lidar packet (cpp:991-1013), staged with its capture
        transform for the next frame."""
        if tf_move_sensor is None:
            tf_move_sensor = np.eye(4, dtype=np.float32)
        sec = int(stamp)
        nsec = int(round((stamp - sec) * 1e9))
        self.engine.add_point_sequence(points_xyz, sec, nsec, tf_move_sensor)

    def set_move_transforms(self, tf_world_move: np.ndarray,
                            tf_crop_move: Optional[np.ndarray] = None):
        """The move-frame transforms of the rollbuffer points (the reference
        looks them up from TF each frame, cpp:171-211; identity when
        missing)."""
        self._tf_world_move = np.asarray(tf_world_move, np.float32)
        self._tf_crop_move = np.asarray(
            tf_world_move if tf_crop_move is None else tf_crop_move,
            np.float32)

    # ------ live reconfig -------------------------------------------------
    def set_flying_pixel_config(self,
                                threshold: Optional[float] = None,
                                size: Optional[int] = None,
                                rot45: Optional[bool] = None):
        """Reconfigure the flying-pixel filter at run time (cpp:970-990).
        The threshold rides in the next frame's packet; a new size or rot45
        builds a new engine on the same device that carries the state and
        the runtime filter scalars (the mapping pipeline, and so its
        tracks, is new, as in the JAX component)."""
        if threshold is not None:
            self.cfg = self.cfg.replace(
                flyingpixels_filter_threshold=float(threshold))
            self.engine.set_runtime_filters(fp_threshold=threshold)
        kw = {}
        if size is not None and size != self.cfg.flyingpixels_filter_size:
            kw["flyingpixels_filter_size"] = int(size)
        if (rot45 is not None
                and rot45 != self.cfg.flyingpixels_filter_enable_rot45):
            kw["flyingpixels_filter_enable_rot45"] = bool(rot45)
        if not kw:
            return
        self.cfg = self.cfg.replace(**kw)
        old_state = self.engine.state
        runtime = (self.engine.fp_threshold, self.engine.fp_max_distance,
                   self.engine.ps_threshold)
        self.engine.close()
        self.engine = FusionEngine(self.cfg, self.device,
                                   enable_mapping=self.enable_mapping)
        self.engine.state = old_state
        self.engine.set_runtime_filters(*runtime)

    # ------ processing ----------------------------------------------------
    @_traced
    def tick_resample(self, now: float) -> Optional[FrameOutputs]:
        """Resample-timer body (cpp:74-90): process the newest stashed
        tuple, if one arrived since the last tick."""
        if not self._stash_new or self._stash is None:
            return None
        self._stash_new = False
        return self._process_tuple(self._stash, now)

    def _process_tuple(self, tup: List[Optional[Stamped]], now: float
                       ) -> FrameOutputs:
        for slot, stamped in enumerate(tup):
            if stamped is None:
                continue  # optional slot missing: its depth is zeros
            m: DepthMessage = stamped.data
            self.engine.add_depthmap(slot, m.depth, m.intrinsics,
                                     m.tf_world_cam, m.tf_crop_cam)
        out = self.engine.process(now, self._tf_world_move,
                                  self._tf_crop_move)
        self.frames_processed += 1
        if self.on_points is not None:
            self.on_points(out)
        if self.enable_mapping and self.on_mapping is not None:
            self.on_mapping(self.engine.segment_and_track(out))
        if self.cfg.enable_debug_output:
            print(profiling.report(self.engine.frame_id - 1), flush=True)
        return out

"""Estimation filter library (a copy of the JAX package's
``mapping/filters.py``; numpy only).

1:1 behavioral translation of the reference's vendored header-only filter
repo (``include/gpu_depthmap_fusion/filter/``), host-side numpy — small-N
per-track state, identical gain math so behavior is testable against the
C++ formulas:

- :class:`GainFilter`              (filter.h:19-91)
- :class:`ObservePredictFilter`    (filter.h:95-155)
- :class:`ConstGlobalVelocityFilter` (const_global_velocity_filter.h:5-90)
- :class:`Orientation2DFilter`     (orientation_2d_filter.h:8-134)
- :class:`RollPitchYawFilter`      (roll_pitch_yaw_filter.h; 3-angle variant)
- :class:`RotatedRectFilter`       (rotated_rect_filter.h:10-169)
- angle wrapping helpers           (wrap_pi.h)
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ros_gpu_depthmap_fusion_tpu_torch.mapping.geometry import RotatedRect

TWO_PI = 2.0 * math.pi


def wrap_to_2pi(rad: float) -> float:
    """Equivalent angle in [0, 2pi) (wrap_pi.h:7-11)."""
    return math.fmod(rad, TWO_PI) + (TWO_PI if rad < 0 else 0.0)


def wrap_to_pi(rad: float) -> float:
    """Equivalent angle in (-pi, pi] (wrap_pi.h:16-20)."""
    return wrap_to_2pi(rad + math.pi) - math.pi


def wrap_to_pi_seq(rad_before: float, rad_now: float) -> float:
    """Unwrap rad_now so the jump from rad_before is <= |pi|
    (wrap_pi.h:25-34)."""
    rad_before = wrap_to_pi(rad_before)
    rad_now = wrap_to_pi(rad_now)
    diff = rad_now - rad_before
    if diff > math.pi:
        rad_now -= TWO_PI
    if diff < -math.pi:
        rad_now += TWO_PI
    return rad_now


def angle_diff(rad_before: float, rad_now: float) -> float:
    """wrap_pi.h:36-41."""
    return wrap_to_pi(wrap_to_pi_seq(rad_before, rad_now) - rad_before)


class GainFilter:
    """EWA filter with dt-corrected gain (filter.h:19-91):
    ``gain_for_dt(dt) = dt / (ref_dt/gain + dt - ref_dt)``."""

    def __init__(self, gain: float = 0.5, reference_dt: float = 1.0, dim: int = 1):
        self.gain = float(gain)
        self.reference_dt = float(reference_dt)
        self.values = np.zeros(dim, dtype=np.float64)
        self.has_values = False

    def gain_for_dt(self, dt: float) -> float:
        if abs(self.gain) < 1e-9:
            return 0.0
        denom = (self.reference_dt / self.gain) + dt - self.reference_dt
        if abs(denom) < 1e-9:
            return 1.0
        return dt / denom

    def filter(self, dt: Optional[float], new_values) -> "GainFilter":
        new_values = np.asarray(new_values, dtype=np.float64)
        if self.has_values:
            g = self.gain if dt is None else self.gain_for_dt(dt)
            self.values = new_values * g + (1.0 - g) * self.values
        else:
            self.values = new_values.copy()
            self.has_values = True
        return self


class ObservePredictFilter:
    """Two GainFilters over the same state (filter.h:95-155)."""

    def __init__(self, prediction_gain=0.5, prediction_gain_dt=1.0,
                 correction_gain=0.5, correction_gain_dt=1.0, dim: int = 1):
        self.prediction_filter = GainFilter(prediction_gain,
                                            prediction_gain_dt, dim)
        self.correction_filter = GainFilter(correction_gain,
                                            correction_gain_dt, dim)
        self.values = np.zeros(dim, dtype=np.float64)
        self.has_values = False

    def _bootstrap(self, values):
        self.values = np.asarray(values, dtype=np.float64).copy()
        self.correction_filter.values = self.values.copy()
        self.prediction_filter.values = self.values.copy()
        self.correction_filter.has_values = True
        self.prediction_filter.has_values = True
        self.has_values = True

    def correct(self, dt: float, observed):
        if self.has_values:
            self.correction_filter.values = self.values.copy()
            self.correction_filter.filter(dt, observed)
            self.values = self.correction_filter.values.copy()
        else:
            self._bootstrap(observed)

    def predict(self, dt: float, prediction):
        if self.has_values:
            self.prediction_filter.values = self.values.copy()
            self.prediction_filter.filter(dt, prediction)
            self.values = self.prediction_filter.values.copy()
        else:
            self._bootstrap(prediction)


class ConstGlobalVelocityFilter:
    """Constant-velocity predict/correct (const_global_velocity_filter.h):
    velocity observed by finite difference, position extrapolated."""

    def __init__(self,
                 value_prediction_gain=1.0, value_prediction_gain_dt=0.1,
                 value_correction_gain=0.3, value_correction_gain_dt=0.1,
                 velocity_prediction_gain=1.0, velocity_prediction_gain_dt=0.1,
                 velocity_correction_gain=0.0, velocity_correction_gain_dt=0.1,
                 dim: int = 2):
        self.value_filter = ObservePredictFilter(
            value_prediction_gain, value_prediction_gain_dt,
            value_correction_gain, value_correction_gain_dt, dim)
        self.velocity_filter = ObservePredictFilter(
            velocity_prediction_gain, velocity_prediction_gain_dt,
            velocity_correction_gain, velocity_correction_gain_dt, dim)
        self.values = np.zeros(dim, dtype=np.float64)
        self.velocity = np.zeros(dim, dtype=np.float64)
        self.predicted_velocity = np.zeros(dim, dtype=np.float64)
        self.last_measurement = np.zeros(dim, dtype=np.float64)
        self.has_last_measurement = False

    def observe(self, dt: float, observed_values):
        self.predict(dt)
        self.correct(dt, observed_values)

    def correct(self, dt: float, observed_values):
        observed_values = np.asarray(observed_values, dtype=np.float64)
        if self.has_last_measurement and abs(dt) > 1e-6:
            observed_velocity = (observed_values - self.last_measurement) / dt
            self.velocity_filter.correct(dt, observed_velocity)
            self.velocity = self.velocity_filter.values.copy()
        self.value_filter.correct(dt, observed_values)
        self.values = self.value_filter.values.copy()
        self.last_measurement = observed_values.copy()
        self.has_last_measurement = True

    def predict(self, dt: float):
        if self.has_last_measurement:
            predicted = self.values + self.velocity * dt
            self.value_filter.predict(dt, predicted)
            self.velocity_filter.predict(dt, self.predicted_velocity)
            self.values = self.value_filter.values.copy()
            self.velocity = self.velocity_filter.values.copy()


class Orientation2DFilter:
    """Angle filter with wrap-aware unwrapping and optional modulo wrap
    (orientation_2d_filter.h; pi/2 wrap for rectangles)."""

    def __init__(self,
                 value_prediction_gain=0.5, value_prediction_gain_dt=1.0,
                 value_correction_gain=0.5, value_correction_gain_dt=1.0,
                 velocity_prediction_gain=0.5, velocity_prediction_gain_dt=1.0,
                 velocity_correction_gain=0.5, velocity_correction_gain_dt=1.0,
                 rotation_wrap: float = 0.0):
        self.filter = ConstGlobalVelocityFilter(
            value_prediction_gain, value_prediction_gain_dt,
            value_correction_gain, value_correction_gain_dt,
            velocity_prediction_gain, velocity_prediction_gain_dt,
            velocity_correction_gain, velocity_correction_gain_dt, dim=1)
        self.rotation_wrap = float(rotation_wrap)
        self.orientation = np.zeros(1, dtype=np.float64)
        self.turnrate = np.zeros(1, dtype=np.float64)

    def observe(self, dt: float, observed: float):
        self.predict(dt)
        self.correct(dt, observed)

    def correct(self, dt: float, observed: float):
        observed = float(np.asarray(observed).reshape(()))
        if self.filter.has_last_measurement:
            last = float(self.filter.last_measurement[0])
            diff = angle_diff(last, observed)
            if self.rotation_wrap != 0.0:
                # orientation_2d_filter.h:64: fold into +-wrap/2 around last
                diff = (-self.rotation_wrap / 2
                        + math.fmod(diff + self.rotation_wrap / 2,
                                    self.rotation_wrap))
            unwrapped = last + diff
        else:
            unwrapped = observed
        self.filter.correct(dt, [unwrapped])
        self.orientation = self.filter.values.copy()
        self.turnrate = self.filter.velocity.copy()

    def predict(self, dt: float):
        self.filter.predict(dt)
        self.orientation = self.filter.values.copy()
        self.turnrate = self.filter.velocity.copy()

    def to_matrix(self) -> np.ndarray:
        c = math.cos(self.orientation[0])
        s = math.sin(self.orientation[0])
        return np.array([[c, s], [s, c]], dtype=np.float64)


class ConstLocalVelocityFilter:
    """Constant-velocity filter whose velocity state lives in the BODY
    frame (const_local_velocity_filter.h:5-129; unused by the reference
    engine — RotatedRectFilter picks the global variant at
    rotated_rect_filter.h:19,44 — but part of the library surface).

    The observed world-frame velocity is rotated into the body frame by an
    :class:`Orientation2DFilter` before filtering; predictions rotate the
    filtered body velocity back to world.
    """

    def __init__(self, orientation_filter: "Orientation2DFilter" = None,
                 **gains):
        self.orientation_filter = orientation_filter or Orientation2DFilter()
        self.filter = ConstGlobalVelocityFilter(dim=2, **gains)
        self.values = np.zeros(2, dtype=np.float64)
        self.local_velocity = np.zeros(2, dtype=np.float64)

    def _rot(self, sign: float) -> np.ndarray:
        a = sign * float(self.orientation_filter.orientation[0])
        c, s = math.cos(a), math.sin(a)
        return np.array([[c, -s], [s, c]], dtype=np.float64)

    def correct(self, dt: float, observed_values):
        observed_values = np.asarray(observed_values, dtype=np.float64)
        g = self.filter
        if g.has_last_measurement and abs(dt) > 1e-6:
            v_world = (observed_values - g.last_measurement) / dt
            v_local = self._rot(-1.0) @ v_world
            g.velocity_filter.correct(dt, v_local)
            self.local_velocity = g.velocity_filter.values.copy()
        g.value_filter.correct(dt, observed_values)
        g.values = g.value_filter.values.copy()
        self.values = g.values.copy()
        g.last_measurement = observed_values.copy()
        g.has_last_measurement = True

    def predict(self, dt: float):
        g = self.filter
        if g.has_last_measurement:
            v_world = self._rot(+1.0) @ self.local_velocity
            predicted = g.values + v_world * dt
            g.value_filter.predict(dt, predicted)
            g.values = g.value_filter.values.copy()
            self.values = g.values.copy()

    def observe(self, dt: float, observed_values):
        self.predict(dt)
        self.correct(dt, observed_values)


class RollPitchYawFilter:
    """Three independent wrap-aware angle filters (roll_pitch_yaw_filter.h;
    unused by the reference engine but part of the library surface)."""

    def __init__(self, **kw):
        self.filters = [Orientation2DFilter(**kw) for _ in range(3)]

    @property
    def orientation(self) -> np.ndarray:
        return np.array([f.orientation[0] for f in self.filters])

    def observe(self, dt: float, rpy):
        for f, a in zip(self.filters, np.asarray(rpy, dtype=np.float64)):
            f.observe(dt, a)

    def correct(self, dt: float, rpy):
        for f, a in zip(self.filters, np.asarray(rpy, dtype=np.float64)):
            f.correct(dt, a)

    def predict(self, dt: float):
        for f in self.filters:
            f.predict(dt)


class RotatedRectFilter:
    """Tracks a rotated rectangle (rotated_rect_filter.h:10-169):
    constant-global-velocity on center (gains 1/0.3/1/0 @ ref_dt 0.1),
    Orientation2D on angle with pi/2 wrap (gains 1/0.5/1/0.5), plain
    GainFilter(0.2) on size."""

    def __init__(self, rrect: Optional[RotatedRect] = None):
        ref_dt = 0.1
        self.orientation_filter = Orientation2DFilter(
            1.0, ref_dt, 0.5, ref_dt,
            1.0, ref_dt, 0.5, ref_dt,
            rotation_wrap=math.pi / 2)
        self.kinematic_filter = ConstGlobalVelocityFilter(
            1.0, ref_dt, 0.3, ref_dt,
            1.0, ref_dt, 0.0, ref_dt, dim=2)
        self.size_filter = GainFilter(0.2, ref_dt, dim=2)
        self.rrect = RotatedRect()
        if rrect is not None:
            self.filter(1.0, rrect)

    def filter(self, dt: float, rrect: RotatedRect):
        self.kinematic_filter.observe(dt, [rrect.center[0], rrect.center[1]])
        self.orientation_filter.correct(dt, math.radians(rrect.angle))
        self.size_filter.filter(dt, [rrect.size[0], rrect.size[1]])
        self.rrect = RotatedRect(
            (float(self.kinematic_filter.values[0]),
             float(self.kinematic_filter.values[1])),
            (float(self.size_filter.values[0]),
             float(self.size_filter.values[1])),
            math.degrees(float(self.orientation_filter.orientation[0])))

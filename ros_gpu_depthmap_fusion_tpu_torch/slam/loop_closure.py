"""Keyframe place recognition + loop-closure edges for the pose graph (port
of the JAX package's ``slam/loop_closure.py``).

The reference has no SLAM at all; this completes the north-star pose-graph
story (SURVEY.md §6): :mod:`.pose_graph` is the optimizer, this module is
the EDGE PRODUCER. Three tiers:

1. candidate retrieval: each keyframe keeps a POOL of its strongest BRIEF
   descriptors; a query scores every non-adjacent keyframe by the mean
   over its pool of the min Hamming distance into the other pool (a
   sampled descriptor-pool match — discriminative where a global
   majority-bit signature washes out). Host numpy, on the descriptors'
   uint32 bits.
2. geometric verification: full mutual/ratio descriptor matching
   (:func:`..slam.features.match`) + RANSAC Kabsch on the matched
   camera-frame 3-D points (:func:`..slam.pose_estimation.ransac_pose`),
   on the closer's device with its own ``torch.Generator``.
   Accepted only with >= ``min_inliers`` inliers, RMSE below threshold,
   and — repetitive-structure guard — a bounded CORRECTION: the measured
   transform may disagree with the current (drifting) pose estimates by
   at most ``max_correction_t``/``max_correction_r``; two different-but-
   similar walls produce metres of disagreement, real drift produces
   centimetres.
3. robust optimization (:func:`close_loops`): odometry chain + loop
   edges, one Gauss-Newton round, then loop edges whose residual stays
   large are dropped as outliers and the graph re-optimizes (a one-shot
   switchable-constraint pass).

The measured relative transform is the pose-graph edge
``Z_ij ~ T_i^{-1} T_j`` (camera-frame points of j mapped onto i).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ros_gpu_depthmap_fusion_tpu_torch.slam import features as feat
from ros_gpu_depthmap_fusion_tpu_torch.slam.lie import se3_log
from ros_gpu_depthmap_fusion_tpu_torch.slam.pose_estimation import (
    ransac_pose)
from ros_gpu_depthmap_fusion_tpu_torch.slam.pose_graph import (
    PoseGraph, optimize)

POOL = 64   # sampled descriptors per keyframe for retrieval


def keyframe_pool(kps: feat.Keypoints) -> np.ndarray:
    """``[POOL, 8]`` u32 descriptor sample: the strongest valid
    keypoints' BRIEF descriptors (wrapped if fewer than POOL). The order
    of equal scores is numpy's unstable ``argsort``, as in the JAX
    package."""
    desc = kps.desc.cpu().numpy().view(np.uint32)
    valid = kps.valid.cpu().numpy()
    score = kps.score.cpu().numpy() * valid
    order = np.argsort(-score)
    good = order[valid[order]][:POOL]
    if len(good) == 0:
        return np.zeros((POOL, 8), np.uint32)
    reps = -(-POOL // len(good))
    return np.tile(desc[good], (reps, 1))[:POOL]


# 256-entry byte-popcount table: indexing the xor BYTES through it costs
# 2 bytes/element vs unpackbits' 8 (which materialized ~1 MB per past
# keyframe per query and degraded badly on long sequences)
_POPCNT8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.uint16)


def pool_scores(query: np.ndarray, pools: np.ndarray,
                chunk: int = 128) -> np.ndarray:
    """Mean-of-min Hamming from ``query [POOL, 8]`` into each of
    ``pools [N, POOL, 8]`` -> ``[N]`` (lower = more similar).

    Chunked over the pools axis so peak memory is O(chunk), not O(N):
    long sequences (thousands of keyframes) stay at a bounded ~50 MB
    working set per query regardless of map size."""
    n = pools.shape[0]
    qb = np.ascontiguousarray(query).view(np.uint8)      # [P, 32]
    pb = np.ascontiguousarray(pools).view(np.uint8)      # [N, P, 32]
    out = np.empty(n, np.float32)
    for s in range(0, n, chunk):
        x = np.bitwise_xor(qb[:, None, None, :], pb[None, s:s + chunk])
        # [P, C, P]: per-pair Hamming distance (<= 256, fits u16)
        d = _POPCNT8[x].sum(-1, dtype=np.uint16)
        out[s:s + chunk] = d.min(axis=2).mean(axis=0)
    return out


def _log_norms(tf: np.ndarray, device) -> Tuple[float, float]:
    """(|rho|, |phi|) of ``se3_log`` of a host transform, in float32 on
    ``device`` (JAX's ``jnp.asarray`` makes float64 float32 too)."""
    err = se3_log(torch.from_numpy(np.asarray(tf, np.float32)).to(device))
    err = err.cpu().numpy()
    return float(np.linalg.norm(err[:3])), float(np.linalg.norm(err[3:]))


@dataclasses.dataclass
class LoopEdge:
    i: int                 # earlier keyframe
    j: int                 # later keyframe
    z: np.ndarray          # measured T_i^-1 T_j (cam_i <- cam_j)
    num_inliers: int
    rmse: float


class LoopCloser:
    """Detects loop-closure edges between non-adjacent keyframes.
    ``device`` has no default; RANSAC draws come from a generator on it
    seeded from ``seed``."""

    def __init__(self, device, min_gap: int = 10, max_candidates: int = 3,
                 max_pool_score: float = 75.0,
                 min_inliers: int = 25, max_rmse: float = 0.08,
                 max_correction_t: float = 1.5,
                 max_correction_r: float = 0.8,
                 ransac_iterations: int = 128,
                 inlier_threshold: float = 0.06, seed: int = 17):
        self.device = torch.device(device)
        self.min_gap = min_gap
        self.max_candidates = max_candidates
        self.max_pool_score = max_pool_score
        self.min_inliers = min_inliers
        self.max_rmse = max_rmse
        self.max_corr_t = max_correction_t
        self.max_corr_r = max_correction_r
        self.ransac_iterations = ransac_iterations
        self.inlier_threshold = inlier_threshold
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self._pools: List[np.ndarray] = []
        self.edges: List[LoopEdge] = []

    def _verify(self, odo, i: int, j: int,
                min_inliers: Optional[int] = None) -> Optional[LoopEdge]:
        min_inliers = self.min_inliers if min_inliers is None \
            else min_inliers
        kf_i, kf_j = odo.keyframes[i], odo.keyframes[j]
        dev = self.device
        matches = feat.match(feat.Keypoints(*(t.to(dev) for t in kf_i.kps)),
                             feat.Keypoints(*(t.to(dev) for t in kf_j.kps)))
        idx_a = matches.idx_a.cpu().numpy()
        idx_b = matches.idx_b.cpu().numpy()
        mvalid = (matches.valid.cpu().numpy()
                  & kf_i.has_depth[idx_a] & kf_j.has_depth[idx_b])
        if int(mvalid.sum()) < min_inliers:
            return None
        src = kf_j.pts_cam[idx_b]
        dst = kf_i.pts_cam[idx_a]
        res = ransac_pose(torch.from_numpy(src).to(dev),
                          torch.from_numpy(dst).to(dev),
                          torch.from_numpy(mvalid).to(dev), self.generator,
                          iterations=self.ransac_iterations,
                          inlier_threshold=self.inlier_threshold)
        ni, rmse = int(res.num_inliers), float(res.rmse)
        if ni < min_inliers or rmse > self.max_rmse:
            return None
        z = res.transform.cpu().numpy()
        # bounded-correction gate: the edge may disagree with the current
        # pose estimates only by plausible accumulated drift — aliased
        # matches between similar structures disagree by metres/radians
        err_t, err_r = _log_norms(
            np.linalg.inv(z) @ np.linalg.inv(kf_i.pose) @ kf_j.pose, dev)
        if err_t > self.max_corr_t or err_r > self.max_corr_r:
            return None
        return LoopEdge(i=i, j=j, z=z, num_inliers=ni, rmse=rmse)

    def observe(self, odo, kf_index: Optional[int] = None
                ) -> List[LoopEdge]:
        """Ingest keyframes up to ``kf_index`` (default: all) and return
        NEW loop edges found for the latest ones. Call after every
        odometry keyframe (online) or once at the end (batch via
        :func:`close_loops`)."""
        n = len(odo.keyframes) if kf_index is None else kf_index + 1
        new_edges: List[LoopEdge] = []
        while len(self._pools) < n:
            j = len(self._pools)
            pool = keyframe_pool(odo.keyframes[j].kps)
            if j >= self.min_gap:
                past = np.stack(self._pools[: j - self.min_gap + 1])
                score = pool_scores(pool, past)
                order = np.argsort(score)[: self.max_candidates]
                for i in order:
                    if score[i] > self.max_pool_score:
                        break
                    edge = self._verify(odo, int(i), j)
                    if edge is not None:
                        new_edges.append(edge)
                        self.edges.append(edge)
            self._pools.append(pool)
        return new_edges

    def propagate(self, odo, steps: int = 2) -> List[LoopEdge]:
        """Closure PROPAGATION: a verified edge (i, j) makes its
        keyframe neighborhood highly likely to close too — retrieval on
        repetitive scenes often surfaces only one of several true
        revisit pairs (the pool sample is ambiguous there), but
        geometric verification of the NEIGHBORS of a confirmed closure
        is cheap and precise. Each accepted neighbor goes through the
        full verification gate (RANSAC + RMSE + bounded correction) at a
        relaxed inlier count (the confirmed-neighbor prior replaces part
        of the statistical burden, and the pairwise consistency filter
        in :func:`close_loops` cross-checks every propagated edge
        against its confirmed neighbor through the short odometry
        chain), so propagation raises recall without touching precision.
        One round over (i+-k, j) and (i, j-+k) for k <= ``steps``."""
        n = len(odo.keyframes)
        seen = {(e.i, e.j) for e in self.edges}
        relaxed = max(12, int(self.min_inliers * 0.6))
        new_edges: List[LoopEdge] = []
        for e in list(self.edges):
            cand = []
            for k in range(1, steps + 1):
                cand += [(e.i + k, e.j), (e.i - k, e.j),
                         (e.i, e.j - k), (e.i, e.j + k),
                         (e.i + k, e.j - k), (e.i - k, e.j + k)]
            for i, j in cand:
                if not (0 <= i < n and 0 <= j < n):
                    continue
                if j - i < self.min_gap or (i, j) in seen:
                    continue
                edge = self._verify(odo, i, j, min_inliers=relaxed)
                seen.add((i, j))
                if edge is not None:
                    new_edges.append(edge)
                    self.edges.append(edge)
        return new_edges


def _consistency_filter(edges: List[LoopEdge], poses0: np.ndarray, device,
                        span: int = 4, tol_t: float = 0.15,
                        tol_r: float = 0.08) -> List[LoopEdge]:
    """Pairwise consistency check (PCM-style): two loop edges whose
    endpoints are within ``span`` keyframes of each other must agree
    through the short odometry chain between them (short-span odometry
    error is centimetres even under drift). A verified-but-degenerate
    measurement (e.g. an aliased match on repetitive distant structure —
    RANSAC-happy yet half a metre off) disagrees with the true neighbors
    and is dropped BEFORE optimization, where it would otherwise pull
    the whole graph.

    Aliased measurements can be CORRELATED (several neighbors matching
    the same repeated structure agree with each other), so a simple
    any-partner vote is not enough: among CONFLICTING edges the heavier
    consistent group wins, weighted by RANSAC inlier count (true
    closures re-find the same physical points and carry the larger
    inlier mass). Edges with no nearby partner pass unchecked."""
    n = len(edges)
    if n <= 1:
        return list(edges)
    near = np.zeros((n, n), bool)
    cons = np.zeros((n, n), bool)
    for a in range(n):
        for b in range(n):
            if a == b:
                continue
            ea, eb = edges[a], edges[b]
            if abs(ea.i - eb.i) > span or abs(ea.j - eb.j) > span:
                continue
            near[a, b] = True
            rel_i = np.linalg.inv(poses0[ea.i]) @ poses0[eb.i]
            rel_j = np.linalg.inv(poses0[ea.j]) @ poses0[eb.j]
            pred = np.linalg.inv(rel_i) @ ea.z @ rel_j
            err_t, err_r = _log_norms(np.linalg.inv(eb.z) @ pred, device)
            cons[a, b] = err_t <= tol_t and err_r <= tol_r
    inl = np.asarray([e.num_inliers for e in edges], np.float64)
    weight = inl + (cons * inl[None, :]).sum(axis=1)
    keep = []
    for a in range(n):
        conflicts = near[a] & ~cons[a]
        if not conflicts.any() or weight[a] >= weight[conflicts].max():
            keep.append(edges[a])
    return keep


def close_loops(odo, closer: Optional[LoopCloser] = None,
                iterations: int = 12,
                loop_weight: float = 1.0,
                odom_weight: float = 1.0,
                outlier_t: float = 0.5,
                outlier_r: float = 0.3) -> Tuple[int, float]:
    """Detect closures over all keyframes, optimize the pose graph and
    write corrected keyframe poses (and re-anchored landmarks) back. The
    default closer, and the pose graph, run on the odometry's device.

    After the first optimization round, loop edges whose residual REMAINS
    above (``outlier_t``, ``outlier_r``) are dropped as aliased matches
    and the graph re-optimizes without them (consistent edges converge to
    ~zero residual; an aliased edge cannot).

    Returns (num_loop_edges_kept, final chi2).
    """
    dev = odo.device
    closer = closer or LoopCloser(dev)
    closer.observe(odo)
    closer.propagate(odo)
    n = len(odo.keyframes)
    if n < 2:
        return 0, 0.0
    poses0 = np.stack([kf.pose for kf in odo.keyframes]).astype(np.float32)

    def solve(edges):
        ei = list(range(n - 1))
        ej = list(range(1, n))
        ez = [np.linalg.inv(poses0[i]) @ poses0[i + 1]
              for i in range(n - 1)]
        ew = [odom_weight] * (n - 1)
        for e in edges:
            ei.append(e.i)
            ej.append(e.j)
            ez.append(e.z)
            ew.append(loop_weight)

        def t(a):
            return torch.from_numpy(a).to(dev)
        graph = PoseGraph(
            poses=t(poses0),
            edge_i=t(np.asarray(ei, np.int32)),
            edge_j=t(np.asarray(ej, np.int32)),
            edge_z=t(np.stack(ez).astype(np.float32)),
            edge_weight=t(np.asarray(ew, np.float32)))
        solved, chi2 = optimize(graph, iterations=iterations)
        return solved.poses.cpu().numpy(), float(chi2[-1])

    edges = _consistency_filter(list(closer.edges), poses0, dev)
    if not edges:
        closer.edges = []
        return 0, 0.0
    new_poses, chi2 = solve(edges)
    kept = []
    for e in edges:
        err_t, err_r = _log_norms(np.linalg.inv(e.z)
                                  @ np.linalg.inv(new_poses[e.i])
                                  @ new_poses[e.j], dev)
        if err_t <= outlier_t and err_r <= outlier_r:
            kept.append(e)
    if len(kept) != len(edges):
        if not kept:
            closer.edges = []
            return 0, 0.0
        new_poses, chi2 = solve(kept)
    # the closer's published edge set is the set the optimization USED
    # (consistency-filtered + outlier-passed) — retracted measurements
    # are not part of the map's accepted closures
    closer.edges = list(kept)

    # landmark re-anchoring: move each landmark with its FIRST observing
    # keyframe's correction  p' = T_new T_old^-1 p
    first_obs = {}
    for k, lm, _ in odo.observations:
        if lm not in first_obs:
            first_obs[lm] = k
    for lm, k in first_obs.items():
        if lm in odo.landmarks:
            corr = new_poses[k] @ np.linalg.inv(poses0[k])
            p = odo.landmarks[lm]
            odo.landmarks[lm] = (corr[:3, :3] @ p + corr[:3, 3]).astype(
                np.float32)
    for k, kf in enumerate(odo.keyframes):
        kf.pose = new_poses[k].astype(np.float32)
    odo.pose = odo.keyframes[-1].pose.copy()
    return len(kept), chi2

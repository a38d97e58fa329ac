"""The port's SLAM modules (``slam/``) against the JAX package's, on the
CPU, from the same seeded numpy inputs.

Bounds (each test names its own):

- ``lie``: within 2e-6 on random and small-angle inputs (``sin``, ``cos``
  and ``arccos`` round differently by an ulp in XLA:CPU and PyTorch).
- ``fast_scores``, ``_nms3``: bit-equal on integer-valued images (the SAD
  sum is exact there).
- ``detect_and_describe``: keypoint ``xy``, ``score`` and ``valid`` equal,
  tie order included; descriptors equal in at least 99.9% of the bits
  (the port steers BRIEF by ``(m10, m01) / hypot``, JAX by ``cos`` and
  ``sin`` of ``arctan2``: an ulp apart, which flips a test whose two
  samples nearly tie).
- ``hamming_matrix`` and ``match``: exact on equal descriptors.
- ``kabsch``: within 1e-5. ``ransac_pose`` with JAX's sample indices: the
  same inliers, the transform within 1e-5.
- ``solve_window`` (4 iterations on a window captured from
  ``tests/test_slam.py``'s odometry scene): poses and landmarks within
  1e-4, the same accept decisions.
- ``pose_graph.optimize`` on ``test_pose_graph_closes_loop``'s graph:
  within 1e-4.
- ``close_loops`` on the same keyframes and draws: the same edges.

RANSAC's draws cannot be JAX's (threefry keys): :class:`JaxDraws` stands
in for the port's ``_sample_hypotheses`` in the parity tests and returns
the indices JAX's ``random.choice`` gives for the keys the JAX code would
split at the same call.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.core import transforms as jtransforms
from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics as JIntr
from ros_gpu_depthmap_fusion_tpu.slam import ba as jba
from ros_gpu_depthmap_fusion_tpu.slam import features as jfeat
from ros_gpu_depthmap_fusion_tpu.slam import lie as jlie
from ros_gpu_depthmap_fusion_tpu.slam import loop_closure as jlc
from ros_gpu_depthmap_fusion_tpu.slam import pose_estimation as jpe
from ros_gpu_depthmap_fusion_tpu.slam import pose_graph as jpg
from ros_gpu_depthmap_fusion_tpu.slam.frontend import (
    RgbdOdometry as JOdometry)

from ros_gpu_depthmap_fusion_tpu_torch.core import transforms
from ros_gpu_depthmap_fusion_tpu_torch.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu_torch.pipeline.datasets import (
    Box, Sphere, SyntheticRigDataset)
from ros_gpu_depthmap_fusion_tpu_torch.slam import ba, lie, loop_closure
from ros_gpu_depthmap_fusion_tpu_torch.slam import features as feat
from ros_gpu_depthmap_fusion_tpu_torch.slam import pose_estimation as pe
from ros_gpu_depthmap_fusion_tpu_torch.slam import pose_graph as pg
from ros_gpu_depthmap_fusion_tpu_torch.slam.ate import (
    ate_rmse, trajectory_positions)
from ros_gpu_depthmap_fusion_tpu_torch.slam.frontend import RgbdOdometry


class JaxDraws:
    """Stands in for ``pose_estimation._sample_hypotheses``: the k-th
    generator it meets draws from the threefry chain of ``seeds[k]``
    (``PRNGKey(seed)``, split once per call as the JAX frontend and loop
    closer split theirs), so each call returns the indices JAX's
    ``ransac_pose`` samples for the same call."""

    def __init__(self, *seeds):
        self.seeds = list(seeds)
        self.keys = {}

    def __call__(self, generator, probs, iterations):
        g = id(generator)
        if g not in self.keys:
            self.keys[g] = jax.random.PRNGKey(self.seeds.pop(0))
        self.keys[g], sub = jax.random.split(self.keys[g])
        p = jnp.asarray(probs.cpu().numpy())
        n = p.shape[0]
        idx = jax.vmap(lambda k: jax.random.choice(
            k, n, shape=(3,), replace=False, p=p))(
                jax.random.split(sub, iterations))
        return torch.from_numpy(np.asarray(idx, np.int64)).to(probs.device)


def t32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def port_kps(k):
    """A JAX ``Keypoints`` as the port's (descriptors as int32 bits)."""
    return feat.Keypoints(
        xy=t32(k.xy), score=t32(k.score), angle=t32(k.angle),
        valid=torch.from_numpy(np.asarray(k.valid)),
        desc=torch.from_numpy(np.asarray(k.desc).view(np.int32).copy()))


def jax_kps(k):
    """The port's ``Keypoints`` as the JAX package's (uint32 bits)."""
    return jfeat.Keypoints(
        xy=jnp.asarray(k.xy.numpy()), score=jnp.asarray(k.score.numpy()),
        angle=jnp.asarray(k.angle.numpy()),
        valid=jnp.asarray(k.valid.numpy()),
        desc=jnp.asarray(k.desc.numpy().view(np.uint32)))


# --- lie --------------------------------------------------------------------

def _lie_inputs(small):
    rng = np.random.default_rng(21)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w = w / np.linalg.norm(w, axis=1, keepdims=True) \
        * rng.uniform(0.01, 3.0, (64, 1)).astype(np.float32)
    rho = rng.normal(size=(64, 3)).astype(np.float32)
    if small:
        # below, at and just above the 1e-6 small-angle switch
        w = w / np.linalg.norm(w, axis=1, keepdims=True) \
            * np.geomspace(1e-9, 3e-6, 64)[:, None].astype(np.float32)
    return w, np.concatenate([rho, w], axis=1)


@pytest.mark.parametrize("small", [False, True], ids=["random", "small"])
def test_lie_matches_jax(small):
    w, xi = _lie_inputs(small)
    r = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    tf = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    pairs = [
        (r, lie.so3_exp(t32(w))),
        (jlie.so3_log(jnp.asarray(r)), lie.so3_log(t32(r))),
        (tf, lie.se3_exp(t32(xi))),
        (jlie.se3_log(jnp.asarray(tf)), lie.se3_log(t32(tf))),
        (jlie.se3_inv(jnp.asarray(tf)), lie.se3_inv(t32(tf))),
        (jlie.skew(jnp.asarray(w)), lie.skew(t32(w))),
    ]
    for k, (a, b) in enumerate(pairs):
        assert b.dtype == torch.float32, k
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-6, err_msg=str(k))


# --- features ---------------------------------------------------------------

def _checker_image(h=96, w=128, seed=0):
    """``tests/test_slam.py``'s corner image, rounded to integers."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for _ in range(30):
        y, x = rng.integers(20, h - 20), rng.integers(20, w - 20)
        s = rng.integers(4, 10)
        img[y:y + s, x:x + s] = np.round(rng.uniform(80, 255))
    return img


def _scene_image(w=320, h=240, seed=9, pose=None):
    """A rendered textured view of ``test_odometry_synthetic_trajectory``'s
    scene, as an integer-valued intensity (a PNG frame's values)."""
    ds = _odometry_scene(w, h, seed)
    _, img = ds.render(np.eye(4, dtype=np.float32) if pose is None
                       else pose)
    return np.clip(np.round(img), 0, 255).astype(np.float32)


def _odometry_scene(w=160, h=120, seed=9):
    intr = PinholeIntrinsics.default_for(w, h)
    rng = np.random.default_rng(seed)
    spheres = [Sphere(rng.uniform(-2, 2, 3) + [0, 0, 3.5],
                      rng.uniform(0.2, 0.5)) for _ in range(8)]
    boxes = [Box(np.array([-0.5, -0.5, 4.0]), np.array([0.8, 0.6, 5.0]))]
    return SyntheticRigDataset(intr, spheres=spheres, boxes=boxes,
                               ground_z=None)


@pytest.mark.parametrize("which", ["checker", "scene"])
def test_fast_scores_and_nms_bit_equal(which):
    img = _checker_image() if which == "checker" else _scene_image()
    for thr in (12.0, 30.0):
        ja = jfeat.fast_scores(jnp.asarray(img), thr)
        ta = feat.fast_scores(torch.from_numpy(img), thr)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(feat._nms3(ta).numpy(),
                                      np.asarray(jfeat._nms3(ja)))


def test_bilinear_and_orientation_match_jax():
    img = _scene_image()
    rng = np.random.default_rng(3)
    coords = rng.uniform(-3, 330, (200, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        feat._bilinear(torch.from_numpy(img), t32(coords)).numpy(),
        np.asarray(jfeat._bilinear(jnp.asarray(img), jnp.asarray(coords))))
    xy = np.stack([rng.integers(16, 300, 64), rng.integers(16, 220, 64)],
                  -1).astype(np.float32)
    np.testing.assert_allclose(
        feat._orientation(torch.from_numpy(img), t32(xy)).numpy(),
        np.asarray(jfeat._orientation(jnp.asarray(img), jnp.asarray(xy))),
        rtol=0, atol=2e-6)


@pytest.mark.parametrize("which,k", [("checker", 128), ("scene", 512),
                                     ("blank", 64)])
def test_detect_and_describe_matches_jax(which, k):
    img = {"checker": _checker_image,
           "scene": _scene_image,
           "blank": lambda: np.zeros((96, 128), np.float32)}[which]()
    ja = jfeat.detect_and_describe(jnp.asarray(img), max_keypoints=k)
    ta = feat.detect_and_describe(torch.from_numpy(img), max_keypoints=k)
    # xy order includes the order of tied scores (every zero score ties)
    np.testing.assert_array_equal(ta.xy.numpy(), np.asarray(ja.xy))
    np.testing.assert_array_equal(ta.score.numpy(), np.asarray(ja.score))
    np.testing.assert_array_equal(ta.valid.numpy(), np.asarray(ja.valid))
    np.testing.assert_allclose(ta.angle.numpy(), np.asarray(ja.angle),
                               rtol=0, atol=2e-6)
    assert ta.desc.dtype == torch.int32 and ta.desc.shape == (k, 8)
    bits_j = np.unpackbits(np.asarray(ja.desc).view(np.uint8))
    bits_t = np.unpackbits(ta.desc.numpy().view(np.uint8))
    assert (bits_j != bits_t).mean() <= 1e-3
    if which == "blank":
        assert not ta.valid.any()


def test_hamming_and_match_exact_on_equal_descriptors():
    img = _checker_image()
    a = jfeat.detect_and_describe(jnp.asarray(img), max_keypoints=128)
    b = jfeat.detect_and_describe(jnp.asarray(np.roll(img, (0, 5), (0, 1))),
                                  max_keypoints=128)
    np.testing.assert_array_equal(
        feat.hamming_matrix(port_kps(a).desc, port_kps(b).desc).numpy(),
        np.asarray(jfeat.hamming_matrix(a.desc, b.desc)))
    for x, y in ((a, b), (a, a), (b, a)):
        jm = jfeat.match(x, y)
        tm = feat.match(port_kps(x), port_kps(y))
        for f in jm._fields:
            np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                          np.asarray(getattr(jm, f)), f)
    assert int(tm.valid.sum()) > 10


def test_popcount_every_bit_pattern_class():
    rng = np.random.default_rng(5)
    words = np.concatenate([
        rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 0x55555555, 0xAAAAAAAA],
                 np.uint32)])
    expect = np.unpackbits(words.view(np.uint8)).reshape(-1, 32).sum(1)
    got = feat._popcount32(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), expect)


# --- pose estimation ---------------------------------------------------------

def _correspondences(n=100, seed=4, outlier_frac=0.3):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, 3)).astype(np.float32) * 2
    tf_true = jtransforms.make_se3(jtransforms.rot_y(0.4),
                                   np.array([0.3, 0.1, -0.2]))
    dst = (src @ tf_true[:3, :3].T + tf_true[:3, 3]).astype(np.float32)
    out = rng.random(n) < outlier_frac
    dst[out] += (rng.normal(size=(out.sum(), 3)) * 2.0).astype(np.float32)
    valid = rng.random(n) > 0.1
    return src, dst, valid, tf_true, out


def test_kabsch_matches_jax():
    rng = np.random.default_rng(3)
    for k in range(4):
        src = rng.normal(size=(20, 3)).astype(np.float32)
        w = (rng.random(20) > 0.3).astype(np.float32)
        tf_true = jtransforms.make_se3(
            jtransforms.rot_z(0.7 * k) @ jtransforms.rot_x(0.2),
            np.array([1.0, -2.0, 0.5]))
        dst = (src @ tf_true[:3, :3].T + tf_true[:3, 3]
               + rng.normal(size=(20, 3)) * 0.01).astype(np.float32)
        jt = np.asarray(jpe.kabsch(jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(w)))
        tt = pe.kabsch(t32(src), t32(dst), t32(w)).numpy()
        np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-5)
    # batched: one call, every hypothesis
    srcs = rng.normal(size=(8, 5, 3)).astype(np.float32)
    dsts = rng.normal(size=(8, 5, 3)).astype(np.float32)
    batch = pe.kabsch(t32(srcs), t32(dsts), torch.ones(8, 5)).numpy()
    for i in range(8):
        np.testing.assert_allclose(
            batch[i], np.asarray(jpe.kabsch(jnp.asarray(srcs[i]),
                                            jnp.asarray(dsts[i]),
                                            jnp.ones(5))),
            rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed,outliers", [(4, 0.3), (6, 0.6)])
def test_ransac_pose_with_jax_draws(monkeypatch, seed, outliers):
    src, dst, valid, _, _ = _correspondences(seed=seed,
                                             outlier_frac=outliers)
    jr = jpe.ransac_pose(jnp.asarray(src), jnp.asarray(dst),
                         jnp.asarray(valid), jax.random.PRNGKey(seed),
                         iterations=64, inlier_threshold=0.08)
    def sample(generator, probs, iterations):
        n = probs.shape[0]
        p = jnp.asarray(probs.numpy())
        idx = jax.vmap(lambda k: jax.random.choice(
            k, n, shape=(3,), replace=False, p=p))(
                jax.random.split(jax.random.PRNGKey(seed), iterations))
        return torch.from_numpy(np.asarray(idx, np.int64))
    monkeypatch.setattr(pe, "_sample_hypotheses", sample)
    tr = pe.ransac_pose(t32(src), t32(dst), torch.from_numpy(valid),
                        torch.Generator().manual_seed(0), iterations=64,
                        inlier_threshold=0.08)
    np.testing.assert_array_equal(tr.inliers.numpy(),
                                  np.asarray(jr.inliers))
    assert int(tr.num_inliers) == int(jr.num_inliers)
    np.testing.assert_allclose(tr.transform.numpy(),
                               np.asarray(jr.transform), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tr.rmse), float(jr.rmse), atol=1e-6)


def test_ransac_pose_own_draws_recovers_transform():
    """``tests/test_slam.py::test_ransac_with_outliers`` on the port."""
    src, dst, _, tf_true, out = _correspondences(outlier_frac=0.3)
    n = src.shape[0]
    g = torch.Generator().manual_seed(0)
    res = pe.ransac_pose(t32(src), t32(dst), torch.ones(n, dtype=bool), g)
    assert int(res.num_inliers) >= (~out).sum() * 0.9
    np.testing.assert_allclose(res.transform.numpy(), tf_true, atol=5e-3)
    # the draws come from the generator: the same seed, the same result
    again = pe.ransac_pose(t32(src), t32(dst), torch.ones(n, dtype=bool),
                           torch.Generator().manual_seed(0))
    assert torch.equal(again.transform, res.transform)
    # fewer than 3 valid rows still draws 3 distinct indices
    idx = pe._sample_hypotheses(torch.Generator().manual_seed(1),
                                torch.tensor([0.5, 0.5, 0.0, 0.0]), 16)
    assert idx.shape == (16, 3)
    assert all(len(set(r)) == 3 for r in idx.tolist())


def test_unproject_keypoints_matches_jax():
    rng = np.random.default_rng(2)
    depth = (rng.uniform(0.5, 4.0, (48, 64)) * (rng.random((48, 64)) > 0.2)
             ).astype(np.float32)
    xy = np.stack([rng.integers(0, 64, 40), rng.integers(0, 48, 40)],
                  -1).astype(np.float32)
    jp, jok = jpe.unproject_keypoints(jnp.asarray(xy), jnp.asarray(depth),
                                      51.3, 50.7, 31.5, 23.5)
    tp, tok = pe.unproject_keypoints(t32(xy), t32(depth), 51.3, 50.7, 31.5,
                                     23.5)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


# --- frontend and BA ---------------------------------------------------------

ODO_KW = dict(max_keypoints=256, min_inliers=8, keyframe_translation=0.08,
              inlier_threshold=0.1)


def _odometry_frames(n=8):
    """``test_odometry_synthetic_trajectory``'s 8 frames: (pose,
    intensity, depth in metres)."""
    ds = _odometry_scene()
    out = []
    for f in range(n):
        t = f * 0.04
        pose = transforms.make_se3(transforms.rot_y(0.02 * f),
                                   np.array([t, 0.5 * t, 0.0]))
        depth_u16, intensity = ds.render(pose)
        out.append((pose, intensity, depth_u16 * 0.001))
    return out


@pytest.fixture(scope="module")
def odometry_runs():
    """The JAX odometry on the scene, and the port's with JAX's draws."""
    frames = _odometry_frames()
    intr = JIntr.default_for(160, 120)
    jodo = JOdometry(intr, **ODO_KW)
    for f, (_, img, depth) in enumerate(frames):
        jodo.process(f / 30.0, img, depth)
    mp = pytest.MonkeyPatch()
    mp.setattr(pe, "_sample_hypotheses", JaxDraws(0))
    try:
        todo = RgbdOdometry(PinholeIntrinsics.default_for(160, 120), "cpu",
                            **ODO_KW)
        for f, (_, img, depth) in enumerate(frames):
            todo.process(f / 30.0, img, depth)
    finally:
        mp.undo()
    return frames, jodo, todo


def test_odometry_matches_jax_with_jax_draws(odometry_runs):
    _, jodo, todo = odometry_runs
    assert len(todo.keyframes) == len(jodo.keyframes) >= 2
    assert len(todo.trajectory) == len(jodo.trajectory) == 8
    for (ts, tp), (js, jp) in zip(todo.trajectory, jodo.trajectory):
        assert ts == js
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-3)
    for tk, jk in zip(todo.keyframes, jodo.keyframes):
        np.testing.assert_array_equal(tk.landmark_ids, jk.landmark_ids)
        np.testing.assert_array_equal(tk.has_depth, jk.has_depth)
    assert todo.landmarks.keys() == jodo.landmarks.keys()
    assert len(todo.observations) == len(jodo.observations)


def test_odometry_own_draws_tracks_and_ba_refines(odometry_runs):
    """``tests/test_slam.py::test_odometry_synthetic_trajectory`` on the
    port with its own draws."""
    frames = odometry_runs[0]
    odo = RgbdOdometry(PinholeIntrinsics.default_for(160, 120), "cpu",
                       **ODO_KW)
    for f, (_, img, depth) in enumerate(frames):
        odo.process(f / 30.0, img, depth)
    est = trajectory_positions(np.stack([p for _, p in odo.trajectory]))
    gt = trajectory_positions(np.stack([p for p, _, _ in frames]))
    assert ate_rmse(est, gt) < 0.05
    assert odo.run_ba(window=8, iterations=5) is not None
    est2 = trajectory_positions(np.stack([kf.pose for kf in odo.keyframes]))
    assert len(est2) >= 3
    assert ate_rmse(est2, gt[: len(est2)]) < 0.1
    assert len(odo.ba_corrections) == 1


def _jax_accepts(problem, iterations):
    """JAX ``solve_window``'s accept decisions: step k was accepted iff
    the poses after k steps differ from those after k - 1."""
    prev = np.asarray(problem.poses)
    out = []
    for k in range(1, iterations + 1):
        cur = np.asarray(jba.solve_window(problem, iterations=k)[0].poses)
        out.append(not np.array_equal(cur, prev))
        prev = cur
    return out


def test_solve_window_matches_jax(odometry_runs):
    """4 iterations on the odometry's last window. Accept decisions are
    held equal where the candidate's chi2 differs from the current one by
    more than 1e-5 relative: closer, the ``<=`` test compares two float32
    sums that each package rounds in its own order (this window's third
    step improves chi2 by 1.2e-6 relative in JAX, about ten ulps, and
    rounds the other way in the port); on this window that step moves no
    pose by more than the 1e-4 bound (on others it can:
    ``test_torch_cuda.py ba_agree``)."""
    _, jodo, _ = odometry_runs
    jprob, _, _ = jodo.build_ba_window(8)
    tprob = ba.BAProblem(*(torch.from_numpy(np.asarray(x)) for x in jprob))
    jsol, jchi = jba.solve_window(jprob, iterations=4)
    poses, lms, chi2s, cands = ba._iterate(tprob, 4, 1e-4)
    np.testing.assert_allclose(poses.numpy(), np.asarray(jsol.poses),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(lms.numpy(), np.asarray(jsol.landmarks),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(chi2s.numpy(), np.asarray(jchi), rtol=1e-3)
    accepts = (cands <= chi2s).tolist()
    decided = ((cands - chi2s).abs() > 1e-5 * chi2s).tolist()
    assert sum(decided) >= 2
    for k, (a, j) in enumerate(zip(accepts, _jax_accepts(jprob, 4))):
        if decided[k]:
            assert a == j, (k, accepts, chi2s, cands)
    tsol, tchi = ba.solve_window(tprob, iterations=4)
    assert torch.equal(tsol.poses, poses) and torch.equal(tchi, chi2s)


def test_solve_window_converges_and_rejects_bad_indices():
    """``tests/test_slam.py::test_ba_converges``'s problem on the port."""
    rng = np.random.default_rng(5)
    m, l = 4, 60
    lms_true = rng.uniform(-3, 3, size=(l, 3)).astype(np.float32)
    lms_true[:, 2] += 5.0
    poses_true = np.stack([transforms.make_se3(
        transforms.rot_y(0.1 * k), np.array([0.5 * k, 0, 0]))
        for k in range(m)])
    op, ol, pt = [], [], []
    for k in range(m):
        for j in range(l):
            p_cam = poses_true[k, :3, :3].T @ (lms_true[j]
                                               - poses_true[k, :3, 3])
            if p_cam[2] > 0.5:
                op.append(k)
                ol.append(j)
                pt.append(p_cam)
    poses0 = poses_true.copy()
    for k in range(1, m):
        poses0[k, :3, 3] += rng.normal(size=3) * 0.05
    lms0 = lms_true + rng.normal(size=lms_true.shape) * 0.05
    prob = ba.BAProblem(
        t32(poses0), t32(lms0), torch.tensor(op, dtype=torch.int32),
        torch.tensor(ol, dtype=torch.int32), t32(np.array(pt)),
        torch.ones(len(op), dtype=torch.bool))
    solved, chi2s = ba.solve_window(prob, iterations=10)
    assert chi2s[-1] < chi2s[0] * 1e-3
    np.testing.assert_allclose(solved.poses.numpy()[1:, :3, 3],
                               poses_true[1:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(solved.landmarks.numpy(), lms_true, atol=1e-3)
    bad_lm = prob.obs_lm.clone()
    bad_lm[3] = l
    bad = prob._replace(obs_lm=bad_lm)
    with pytest.raises(ValueError, match="obs_lm"):
        ba.solve_window(bad, iterations=1)


# --- pose graph and loop closure ---------------------------------------------

def _loop_graph():
    """``tests/test_slam.py::test_pose_graph_closes_loop``'s graph."""
    rng = np.random.default_rng(7)
    n = 6
    poses_true = [np.eye(4, dtype=np.float32)]
    for k in range(1, n):
        step = transforms.make_se3(transforms.rot_z(2 * np.pi / n),
                                   np.array([1.0, 0, 0]))
        poses_true.append((poses_true[-1] @ step).astype(np.float32))
    poses_true = np.stack(poses_true)
    poses0 = poses_true.copy()
    for k in range(1, n):
        poses0[k, :3, 3] += rng.normal(size=3) * 0.1
    ei = list(range(n - 1)) + [n - 1]
    ej = list(range(1, n)) + [0]
    ez = np.stack([np.linalg.inv(poses_true[i]) @ poses_true[j]
                   for i, j in zip(ei, ej)]).astype(np.float32)
    return (poses0, np.array(ei, np.int32), np.array(ej, np.int32), ez,
            np.ones(len(ei), np.float32)), poses_true


def test_pose_graph_optimize_matches_jax():
    arrays, poses_true = _loop_graph()
    jopt, jchi = jpg.optimize(jpg.PoseGraph(*map(jnp.asarray, arrays)),
                              iterations=10)
    topt, tchi = pg.optimize(pg.PoseGraph(*map(torch.from_numpy, arrays)),
                             iterations=10)
    np.testing.assert_allclose(topt.poses.numpy(), np.asarray(jopt.poses),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tchi[0].item(), float(jchi[0]), rtol=1e-5)
    assert float(tchi[-1]) < float(tchi[0]) * 1e-4
    np.testing.assert_allclose(topt.poses.numpy()[:, :3, 3],
                               poses_true[:, :3, 3], atol=1e-3)


@pytest.mark.parametrize("near", [False, True], ids=["general", "small"])
def test_pose_graph_jacobians_match_jax_jacfwd(near):
    """The edge Jacobians against ``jax.jacfwd``; ``small`` puts every
    edge residual on ``se3_log``'s small-angle branch (a converged
    graph)."""
    arrays, poses_true = _loop_graph()
    poses = poses_true if near else arrays[0]
    ei, ej, ez = arrays[1], arrays[2], arrays[3]

    def jres(ti, tj, z):
        r = jpg._edge_residual(ti, tj, z)
        ji = jax.jacfwd(lambda xi: jpg._edge_residual(
            jpg._perturb(ti, xi), tj, z))(jnp.zeros(6))
        jj = jax.jacfwd(lambda xi: jpg._edge_residual(
            ti, jpg._perturb(tj, xi), z))(jnp.zeros(6))
        return r, ji, jj
    want = jax.jit(jax.vmap(jres))(jnp.asarray(poses[ei]),
                                   jnp.asarray(poses[ej]), jnp.asarray(ez))
    got = pg._residual_jac(t32(poses[ei]), t32(poses[ej]), t32(ez))
    if near:
        assert float(np.abs(np.asarray(want[0])).max()) < 1e-5
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5)


def test_keyframe_pool_and_scores_match_jax():
    img = _scene_image()
    ja = jfeat.detect_and_describe(jnp.asarray(img), max_keypoints=512)
    ta = port_kps(ja)
    pj, pt = jlc.keyframe_pool(ja), loop_closure.keyframe_pool(ta)
    assert pt.dtype == np.uint32
    np.testing.assert_array_equal(pt, pj)
    pools = np.stack([pj, pj[::-1], np.roll(pj, 3, axis=1)])
    np.testing.assert_array_equal(loop_closure.pool_scores(pj, pools),
                                  jlc.pool_scores(pj, pools))


def test_close_loops_matches_jax_on_the_same_keyframes(odometry_runs,
                                                       monkeypatch):
    """The JAX odometry's keyframes of the scene, copied into each package,
    closed with a 2-keyframe gap (every non-adjacent pair is a candidate)
    and JAX's draws (the closer's seed 17): the same edges, inlier counts
    and measured transforms, and the same optimized poses."""
    import copy
    from ros_gpu_depthmap_fusion_tpu.slam.frontend import Keyframe as JKf
    from ros_gpu_depthmap_fusion_tpu_torch.slam.frontend import Keyframe
    _, jodo0, _ = odometry_runs
    jodo = JOdometry(JIntr.default_for(160, 120), **ODO_KW)
    todo = RgbdOdometry(PinholeIntrinsics.default_for(160, 120), "cpu",
                        **ODO_KW)
    for odo, kf_cls, kps in ((jodo, JKf, lambda k: k),
                             (todo, Keyframe, port_kps)):
        odo.keyframes = [kf_cls(stamp=k.stamp, pose=k.pose.copy(),
                                kps=kps(k.kps), pts_cam=k.pts_cam.copy(),
                                has_depth=k.has_depth.copy(),
                                landmark_ids=k.landmark_ids.copy())
                         for k in jodo0.keyframes]
        odo.landmarks = copy.deepcopy(jodo0.landmarks)
        odo.observations = copy.deepcopy(jodo0.observations)
        odo.pose = jodo0.pose.copy()
    assert len(jodo.keyframes) >= 4
    jcloser = jlc.LoopCloser(min_gap=2)
    jn, _ = jlc.close_loops(jodo, jcloser)
    monkeypatch.setattr(pe, "_sample_hypotheses", JaxDraws(17))
    tcloser = loop_closure.LoopCloser("cpu", min_gap=2)
    tn, _ = loop_closure.close_loops(todo, tcloser)
    assert tn == jn >= 2
    assert [(e.i, e.j, e.num_inliers) for e in tcloser.edges] == \
        [(e.i, e.j, e.num_inliers) for e in jcloser.edges]
    for te, je in zip(tcloser.edges, jcloser.edges):
        np.testing.assert_allclose(te.z, je.z, rtol=0, atol=1e-5)
        assert abs(te.rmse - je.rmse) < 1e-6
    for tk, jk in zip(todo.keyframes, jodo.keyframes):
        np.testing.assert_allclose(tk.pose, jk.pose, rtol=0, atol=1e-4)
    for i, p in jodo.landmarks.items():
        np.testing.assert_allclose(todo.landmarks[i], p, rtol=0, atol=1e-4)

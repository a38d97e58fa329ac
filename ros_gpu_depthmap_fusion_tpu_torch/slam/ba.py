"""Windowed bundle adjustment with Schur-complement reduction (port of the
JAX package's ``slam/ba.py`` ``solve_window`` and its helpers).

Gauss-Newton over a window of keyframe poses and 3-D landmarks with RGB-D
point observations (landmark measured in camera frame). The landmark block
of the Hessian is eliminated analytically (each observation contributes an
identity 3x3 to its landmark block, so ``H_ll = (count + lambda) * I`` and
the Schur complement is one dense matmul over the per-landmark coupling
matrices).

Where the port departs from the JAX code's letter:

- The scatter-adds (``.at[].add(..., mode="drop")``) are ``index_add_``.
  On CUDA these are atomics in no fixed order, so BA on the card agrees
  with the CPU within a bound, not bit for bit. ``mode="drop"`` matters
  only for out-of-range indices, which the frontend never builds;
  :func:`solve_window` raises on them instead of dropping them.
- The block-diagonal ``fori_loop`` of ``dynamic_update_slice`` is one
  indexed assignment.
- ``lax.scan`` with its data-dependent accept is a Python loop over the
  iterations whose accept / reject is a tensor ``where``: no host sync
  inside the loop, and the damping stays a 0-d tensor on the device.
- The linear solve is ``torch.linalg.solve_ex`` (no error check, so no
  host sync; a singular system gives non-finite steps, which the chi2
  test rejects, as JAX's ``solve`` returns them).

Distribution (:func:`build_sharded_ba_step`): landmarks and their
observations shard over one axis of a :class:`parallel.mesh.Mesh`; each
rank reduces its contribution to the ``[6M, 6M]`` reduced camera system,
the contributions and chi2 are summed over the axis, and every rank solves
the small dense system itself while back-substituting only its own
landmarks.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ros_gpu_depthmap_fusion_tpu_torch.slam.lie import se3_exp, skew


class BAProblem(NamedTuple):
    """Static-shape BA window.

    poses:     [M, 4, 4] world <- camera.
    landmarks: [L, 3] world points.
    obs_pose:  [O] int32 pose index per observation.
    obs_lm:    [O] int32 landmark index.
    obs_pt:    [O, 3] measured camera-frame point.
    obs_valid: [O] bool.
    """
    poses: torch.Tensor
    landmarks: torch.Tensor
    obs_pose: torch.Tensor
    obs_lm: torch.Tensor
    obs_pt: torch.Tensor
    obs_valid: torch.Tensor


def _residuals_and_blocks(poses, landmarks, obs_pose, obs_lm, obs_pt,
                          obs_valid):
    """Per-observation residual r = R^T (X - t) - z and Jacobian blocks
    J_pose [O, 3, 6] (d r / d [dt, dtheta]) and J_lm = R^T [O, 3, 3]."""
    r_wc = poses[obs_pose, :3, :3]                  # [O, 3, 3]
    t_wc = poses[obs_pose, :3, 3]                   # [O, 3]
    x = landmarks[obs_lm]                           # [O, 3]
    rt = torch.swapaxes(r_wc, -1, -2)
    p_cam = torch.einsum("oij,oj->oi", rt, x - t_wc)
    res = p_cam - obs_pt                            # [O, 3]
    j_t = -rt                                       # d r / d delta_t
    j_th = skew(p_cam)                              # d r / d delta_theta
    j_pose = torch.cat([j_t, j_th], dim=-1)         # [O, 3, 6]
    j_lm = rt                                       # [O, 3, 3]
    w = obs_valid.to(poses.dtype)
    return res, j_pose, j_lm, w


HUBER_DELTA = 0.15   # metres; residuals beyond this are IRLS-down-weighted
# stereo-depth noise model sigma(z) = SIGMA0 + SIGMA2 * z^2 (RealSense
# class); observations are weighted by (sigma(2m)/sigma(z))^2 so a 6 m
# return (sigma ~ 9x a 1 m return) cannot bias the pose the way an
# isotropic weighting lets it
SIGMA0 = 0.001
SIGMA2 = 0.0025


def _huber_w(res, w, z):
    """Measurement weighting: depth-noise normalization (1/sigma(z)^2,
    normalized at 2 m) x Huber IRLS (1 inside HUBER_DELTA, delta/|r|
    beyond — keeps outlier observations, e.g. bad landmark inheritances
    that survive the frontend gates, from dominating the normal
    equations)."""
    sig = SIGMA0 + SIGMA2 * z * z
    sig_ref = SIGMA0 + SIGMA2 * 4.0
    w = w * (sig_ref / sig) ** 2
    rn = torch.sqrt(torch.sum(res * res, dim=-1) + 1e-12)
    return w * torch.clamp(HUBER_DELTA / rn, max=1.0)


def _chi2(res, w):
    return torch.sum(w * torch.sum(res * res, dim=-1))


def _reduce_local(poses, landmarks, obs_pose, obs_lm, obs_pt, obs_valid,
                  num_poses: int, num_landmarks: int):
    """One window's contributions: (Hpp [M,6,6], b_p [M,6], W [L, 6M, 3]
    as [L, M, 6, 3], counts [L], b_l [L, 3], chi2)."""
    m, l = num_poses, num_landmarks
    dev = poses.device
    res, j_pose, j_lm, w = _residuals_and_blocks(
        poses, landmarks, obs_pose, obs_lm, obs_pt, obs_valid)
    w = _huber_w(res, w, obs_pt[:, 2])
    jw = j_pose * w[:, None, None]
    op, ol = obs_pose.long(), obs_lm.long()
    hpp = torch.zeros((m, 6, 6), device=dev).index_add_(
        0, op, torch.einsum("oik,oil->okl", jw, j_pose))
    b_p = torch.zeros((m, 6), device=dev).index_add_(
        0, op, -torch.einsum("oik,oi->ok", jw, res))
    # landmark blocks: J_lm^T J_lm = I per valid obs
    counts = torch.zeros((l,), device=dev).index_add_(0, ol, w)
    b_l = torch.zeros((l, 3), device=dev).index_add_(
        0, ol, -torch.einsum("oij,oi->oj", j_lm * w[:, None, None], res))
    # coupling W[j, i] = sum_obs J_pose^T J_lm  (6x3)
    wpl = torch.einsum("oik,oij->okj", jw, j_lm)    # [O, 6, 3]
    coupling = torch.zeros((l * m, 6, 3), device=dev).index_add_(
        0, ol * m + op, wpl).reshape(l, m, 6, 3)
    return hpp, b_p, coupling, counts, b_l, _chi2(res, w)


def _schur_terms(coupling, counts, b_l, damping):
    """A window's (or a landmark shard's) Schur-complement terms: (inv
    H_ll [L], W [L, 6M, 3], its contribution ``- sum_j W_j inv_hll_j
    W_j^T`` to the reduced system [6M, 6M], and ``- sum_j W_j inv_hll_j
    b_l_j`` to its right-hand side [6M])."""
    m, l = coupling.shape[1], counts.shape[0]
    inv_hll = 1.0 / (counts + damping)              # [L] (H_ll = c*I + lam)
    # pose-major flatten: row = i * 6 + a
    w_flat = coupling.reshape(l, 6 * m, 3)
    ws = w_flat * inv_hll[:, None, None]
    return (inv_hll, w_flat, -torch.einsum("lak,lbk->ab", ws, w_flat),
            -torch.einsum("lak,lk->a", ws, b_l))


def _solve_poses(hpp, b_p, s_schur, b_schur, damping,
                 fix_first: bool = True):
    """The pose step [M, 6] of the reduced system ``S = Hpp_blockdiag +
    lambda I + s_schur``, ``b = b_p + b_schur``."""
    m = hpp.shape[0]
    dev = hpp.device
    s4 = torch.zeros((m, 6, m, 6), device=dev)
    ar = torch.arange(m, device=dev)
    s4[ar, :, ar, :] = hpp
    s_full = s4.reshape(6 * m, 6 * m)
    s_full = s_full + damping * torch.eye(6 * m, device=dev)
    s_full = s_full + s_schur
    b_red = b_p.reshape(-1) + b_schur

    if fix_first:
        # gauge fix: pin pose 0 (identity rows/cols, zero rhs)
        mask = torch.cat([torch.zeros(6, device=dev),
                          torch.ones(6 * (m - 1), device=dev)])
        s_full = (s_full * mask[:, None] * mask[None, :]
                  + torch.diag(1.0 - mask))
        b_red = b_red * mask

    return torch.linalg.solve_ex(s_full, b_red)[0].reshape(m, 6)


def _apply_delta(poses, landmarks, delta_p, delta_l):
    """Pose update: R <- R exp([dtheta]x), t <- t + dt."""
    dr = se3_exp(torch.cat([torch.zeros_like(delta_p[:, :3]),
                            delta_p[:, 3:]], dim=-1))
    new_poses = poses.clone()
    new_poses[:, :3, :3] = poses[:, :3, :3] @ dr[:, :3, :3]
    new_poses[:, :3, 3] = poses[:, :3, 3] + delta_p[:, :3]
    return new_poses, landmarks + delta_l


def _check_indices(problem: BAProblem) -> None:
    """Raise on observation indices outside the window (one host sync):
    the JAX package drops their updates (``mode="drop"``); the frontend
    never builds them."""
    m, l = problem.poses.shape[0], problem.landmarks.shape[0]
    bad = ((problem.obs_pose < 0) | (problem.obs_pose >= m)
           | (problem.obs_lm < 0) | (problem.obs_lm >= l)).any()
    if bool(bad):
        raise ValueError(f"BAProblem: obs_pose or obs_lm outside the "
                         f"window's {m} poses / {l} landmarks")


def _iterate(problem: BAProblem, iterations: int, damping: float,
             psum=None):
    """The iterations of :func:`solve_window`. Returns (poses, landmarks,
    chi2 [iters] before each step, chi2 [iters] of each step's candidate);
    a step is accepted where its candidate's chi2 is not larger.

    ``psum(*tensors)`` (a landmark shard's BA, :func:`build_sharded_ba_step`)
    sums the reduced system's parts and the chi2s over the shards before
    each solve and each accept decision, so every shard takes the same
    step."""
    _check_indices(problem)
    m = problem.poses.shape[0]
    l = problem.landmarks.shape[0]
    dev = problem.poses.device
    poses, landmarks = problem.poses, problem.landmarks
    damp = torch.tensor(damping, dtype=torch.float32, device=dev)
    floor = damp.clone()
    ceil = torch.tensor(1e3, dtype=torch.float32, device=dev)
    chi2s, cands = [], []
    for _ in range(iterations):
        hpp, b_p, coupling, counts, b_l, chi2 = _reduce_local(
            poses, landmarks, problem.obs_pose, problem.obs_lm,
            problem.obs_pt, problem.obs_valid, m, l)
        inv_hll, w_flat, s_schur, b_schur = _schur_terms(coupling, counts,
                                                         b_l, damp)
        if psum is not None:
            hpp, b_p, s_schur, b_schur, chi2 = psum(hpp, b_p, s_schur,
                                                    b_schur, chi2)
        dp = _solve_poses(hpp, b_p, s_schur, b_schur, damp)
        # back-substitute landmarks: dl = inv_hll (b_l - W^T dp)
        wtdp = torch.einsum("lak,a->lk", w_flat, dp.reshape(-1))
        cand_p, cand_l = _apply_delta(poses, landmarks, dp,
                                      inv_hll[:, None] * (b_l - wtdp))
        res, _, _, w = _residuals_and_blocks(
            cand_p, cand_l, problem.obs_pose, problem.obs_lm,
            problem.obs_pt, problem.obs_valid)
        w = _huber_w(res, w, problem.obs_pt[:, 2])
        cand = _chi2(res, w)
        if psum is not None:
            (cand,) = psum(cand)
        accept = cand <= chi2
        poses = torch.where(accept, cand_p, poses)
        landmarks = torch.where(accept, cand_l, landmarks)
        damp = torch.clamp(torch.where(accept, damp * 0.5, damp * 8.0),
                           floor, ceil)
        chi2s.append(chi2)
        cands.append(cand)
    return poses, landmarks, torch.stack(chi2s), torch.stack(cands)


def solve_window(problem: BAProblem, iterations: int = 8,
                 damping: float = 1e-4) -> Tuple[BAProblem, torch.Tensor]:
    """Run fixed Gauss-Newton iterations on the problem's device; returns
    (problem', chi2 [iters]).

    Levenberg-Marquardt step control: a candidate update is ACCEPTED only
    if it does not increase chi2; rejected steps raise the damping 8x,
    accepted ones relax it 2x (floored at the configured damping). Plain
    fixed-iteration GN diverged on real odometry windows with outlier
    landmark inheritances (the JAX package measured chi2 0.67 -> 19.5 on
    a captured window)."""
    poses, landmarks, chi2s, _ = _iterate(problem, iterations,
                                                     damping)
    return problem._replace(poses=poses, landmarks=landmarks), chi2s


def build_sharded_ba_step(mesh, axis: str, num_poses: int,
                          landmarks_per_shard: int, obs_per_shard: int,
                          iterations: int = 8, damping: float = 1e-4):
    """Distributed BA over ``axis`` of ``mesh`` (a
    :class:`parallel.mesh.Mesh`; every rank of the axis calls the step
    together). Landmarks and their observations are sharded over the
    axis, poses replicated.

    Returns ``step(poses [M, 4, 4], landmarks [Ls, 3], obs_pose [Os],
    obs_lm [Os], obs_pt [Os, 3], obs_valid [Os])`` on ``mesh.device``,
    with this rank's landmarks and observations (``obs_lm`` local to the
    shard), giving ``(poses, this shard's landmarks, chi2 [iterations],
    candidate chi2 [iterations])``: the JAX step's three outputs and, as
    :func:`_iterate` returns them, each step's summed candidate chi2 (a
    step was accepted where it is not larger). The five parts of the reduced system (Hpp, b_p, the Schur terms and chi2)
    are summed in one ``all_reduce`` on the axis' group, the candidate's
    chi2 in another; float32 throughout (the package keeps TF32 off).
    """
    from ros_gpu_depthmap_fusion_tpu_torch.parallel.mesh import all_reduce
    import torch.distributed as dist

    def psum(*parts):
        flat = torch.cat([p.reshape(-1) for p in parts])
        flat = all_reduce(flat, dist.ReduceOp.SUM, mesh, axis)
        out, off = [], 0
        for p in parts:
            out.append(flat[off:off + p.numel()].reshape(p.shape))
            off += p.numel()
        return out

    def step(poses, landmarks, obs_pose, obs_lm, obs_pt, obs_valid):
        shapes = ((poses.shape[0], num_poses, "poses"),
                  (landmarks.shape[0], landmarks_per_shard, "landmarks"),
                  (obs_pose.shape[0], obs_per_shard, "observations"))
        for got, want, what in shapes:
            if got != want:
                raise ValueError(f"build_sharded_ba_step: {got} {what} on "
                                 f"this shard, built for {want}")
        return _iterate(BAProblem(poses, landmarks, obs_pose, obs_lm,
                                  obs_pt, obs_valid), iterations, damping,
                        psum)

    return step

"""Pose-graph optimization over keyframe poses (port of the JAX package's
``slam/pose_graph.py``).

Nodes are world<-camera SE(3) poses; edges carry measured relative
transforms ``Z_ij ~ T_i^{-1} T_j`` (odometry and loop closures). Gauss-
Newton on the se(3) residual ``log(Z_ij^{-1} T_i^{-1} T_j)`` with
Jacobians by forward-mode differentiation over local perturbations —
``torch.func.jvp`` along each basis direction, the derivative the JAX
package's ``jax.jacfwd`` under ``jax.vmap`` computes (graphs are small —
keyframes only — so the dense [6N, 6N] system is fine on the device).

The per-edge block scatter (a ``fori_loop`` of ``dynamic_update_slice``
adds in JAX) is one ``index_put_(accumulate=True)``; on CUDA its adds are
atomics in no fixed order, so the card agrees with the CPU within a bound.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ros_gpu_depthmap_fusion_tpu_torch.slam.lie import (
    se3_exp, se3_inv, se3_log)


class PoseGraph(NamedTuple):
    poses: torch.Tensor       # [N, 4, 4]
    edge_i: torch.Tensor      # [E] int32
    edge_j: torch.Tensor      # [E] int32
    edge_z: torch.Tensor      # [E, 4, 4] measured T_i^-1 T_j
    edge_weight: torch.Tensor  # [E]


def _edge_residual(ti, tj, z):
    return se3_log(se3_inv(z) @ se3_inv(ti) @ tj)


def _perturb(t, xi):
    return t @ se3_exp(xi)


def _residual_jac(ti, tj, z):
    """Every edge's residual [E, 6] and its Jacobians [E, 6, 6] in the
    local perturbations of its two poses, at zero: ``jacfwd``'s forward
    derivative, one ``jvp`` per basis direction (``vmap``-ed) over all
    edges at once. Batching the edges in the function, not by ``vmap``,
    keeps per-edge scalars out of the traced code: PyTorch (2.13) gives a
    0-d tensor times a Python float a float64 tangent under
    ``vmap(jvp)``, which then fails in a float32 matmul."""
    zero = torch.zeros(ti.shape[:-2] + (6,), dtype=ti.dtype,
                       device=ti.device)
    basis = torch.eye(6, dtype=ti.dtype, device=ti.device)[:, None, :] \
        .expand((6,) + zero.shape)

    def jac(f):
        cols = torch.func.vmap(
            lambda v: torch.func.jvp(f, (zero,), (v,))[1])(basis)
        return cols.permute(1, 2, 0)                     # [E, out, in]
    r = _edge_residual(ti, tj, z)
    ji = jac(lambda xi: _edge_residual(_perturb(ti, xi), tj, z))
    jj = jac(lambda xi: _edge_residual(ti, _perturb(tj, xi), z))
    return r, ji, jj


def _hessian(n: int, ei, ej, wi, wj, ji, jj) -> torch.Tensor:
    """The [6n, 6n] normal matrix: per edge the blocks (i, i), (i, j),
    (j, i), (j, j) of ``J^T W J``, added in the JAX package's order (every
    edge's (i, i) block, then (i, j), ...), one accumulate."""
    blocks = torch.cat([torch.einsum("eik,eil->ekl", a, b)
                        for a, b in ((wi, ji), (wi, jj), (wj, ji), (wj, jj))])
    h4 = torch.zeros((n, n, 6, 6), dtype=ji.dtype, device=ji.device)
    h4.index_put_((torch.cat([ei, ei, ej, ej]), torch.cat([ei, ej, ei, ej])),
                  blocks, accumulate=True)
    return h4.permute(0, 2, 1, 3).reshape(6 * n, 6 * n)


def optimize(graph: PoseGraph, iterations: int = 10,
             damping: float = 1e-6) -> Tuple[PoseGraph, torch.Tensor]:
    """Gauss-Newton with pose 0 gauge-fixed, on the graph's device. Returns
    (graph', chi2[iters]). No host sync between iterations (the solve is
    ``torch.linalg.solve_ex``)."""
    n = graph.poses.shape[0]
    dev = graph.poses.device
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    w = graph.edge_weight
    mask = torch.cat([torch.zeros(6, device=dev),
                      torch.ones(6 * (n - 1), device=dev)])
    cols = torch.arange(6, device=dev)[None, :]
    poses = graph.poses
    chi2s = []
    for _ in range(iterations):
        r, ji, jj = _residual_jac(poses[ei], poses[ej], graph.edge_z)
        chi2s.append(torch.sum(w * torch.sum(r * r, dim=-1)))
        wi = ji * w[:, None, None]
        wj = jj * w[:, None, None]
        h = _hessian(n, ei, ej, wi, wj, ji, jj)
        bi = -torch.einsum("eik,ei->ek", wi, r)
        bj = -torch.einsum("eik,ei->ek", wj, r)
        b = torch.zeros((6 * n,), device=dev)
        b = b.index_add(0, (ei[:, None] * 6 + cols).reshape(-1),
                        bi.reshape(-1))
        b = b.index_add(0, (ej[:, None] * 6 + cols).reshape(-1),
                        bj.reshape(-1))

        # gauge fix node 0
        h = h * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        h = h + damping * torch.eye(6 * n, device=dev)
        b = b * mask
        delta = torch.linalg.solve_ex(h, b)[0].reshape(n, 6)
        poses = _perturb(poses, delta)
    return graph._replace(poses=poses), torch.stack(chi2s)

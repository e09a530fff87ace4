"""Two-view geometry: batched DLT triangulation.

Counterpart of ``triangulate_dlt`` in ``orb_slam3_fast_tpu/ops/twoview.py``
(GeometricTools::Triangulate, GeometricTools.cc:49-73).  The rest of that
module (two-view reconstruction for mono init) waits for ROADMAP §A item 7.

``triangulate_dlt`` is the wrapper of kernel G (``csrc/triangulate_dlt.cu``);
``triangulate_dlt_plain`` is the JAX code as it stands, an SVD per match.

Kernel G -- source note.
  Replaces: ``triangulate_dlt`` (``orb_slam3_fast_tpu/ops/twoview.py:164``,
  K14), a batched (N,4,4) ``jnp.linalg.svd`` on rows padded to 256 * 2^k.
  Bound on the card: latency.  A local-mapping pass triangulates a few
  hundred matches per neighbour, ~1 kflop each; a batched library SVD pays
  several launches and a workspace per call.
  Design: one thread per match builds the 4x4 ``A`` as the reference does,
  forms ``A^T A`` in float64 (the H100 has full-rate fp64 units) and runs
  cyclic Jacobi sweeps on it until the off-diagonal squares fall below
  1e-32 of the diagonal's (at most 30 sweeps); the eigenvector of the least eigenvalue is the right
  singular vector of the least singular value.  Its sign is arbitrary, as
  the SVD's is, and cancels in ``X[:3] / w``; ``|w| < 1e-12`` is guarded as
  in the reference.  In float64 the squared condition number of ``A^T A``
  costs nothing at the accuracy float32 inputs carry.
"""
from __future__ import annotations

import torch

from orb_slam3_fast_tpu_torch import _kernels


def triangulate_dlt_plain(P0: torch.Tensor, P1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel G.  P: (3,4) projections, x: (N,2)
    normalised coordinates; returns (N,3) points."""
    A = torch.stack(
        [x0[:, 0:1] * P0[2] - P0[0], x0[:, 1:2] * P0[2] - P0[1], x1[:, 0:1] * P1[2] - P1[0],
         x1[:, 1:2] * P1[2] - P1[1]], dim=1,
    )  # (N,4,4)
    _, _, vt = torch.linalg.svd(A)
    X = vt[..., -1, :]
    w = X[..., 3:]
    return X[..., :3] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)


def triangulate_dlt(P0: torch.Tensor, P1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Kernel G on CUDA tensors, its plain version on CPU ones."""
    if x0.device.type == "cpu":
        return triangulate_dlt_plain(P0, P1, x0, x1)
    f32 = torch.float32
    P0, P1 = P0.to(f32).contiguous(), P1.to(f32).contiguous()
    _kernels.require_cuda(
        "triangulate_dlt", P0=(P0, f32), P1=(P1, f32), x0=(x0, f32), x1=(x1, f32),
    )
    n = x0.shape[0]
    if P0.shape != (3, 4) or P1.shape != (3, 4) or x0.shape != (n, 2) or x1.shape != (n, 2):
        raise ValueError("triangulate_dlt: needs (3,4) projections and (N,2) points")
    X = torch.empty((n, 3), dtype=f32, device=x0.device)
    _kernels.launch(
        "triangulate_dlt_launch", x0.device, P0.data_ptr(), P1.data_ptr(), x0.data_ptr(), x1.data_ptr(), n,
        X.data_ptr(),
    )
    triangulate_dlt.launches += 1
    return X


triangulate_dlt.launches = 0

"""Parity of the port's visual-inertial BA (kernel Y's plain version) with
the JAX package, on tests/test_vi_ba.py's simulated flight: the plain
problem, and one shaped as the tracker builds it (a camera offset from the
body, stereo edges, outliers, padded fixed states repeating the newest
keyframe, invalid landmarks and padded observations)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_fast_tpu.cameras import models as jcam
from orb_slam3_fast_tpu.optim import vi_ba as jvb
from orb_slam3_fast_tpu.utils import lie as jlie
from orb_slam3_fast_tpu_torch.cameras import models as tcam
from orb_slam3_fast_tpu_torch.optim import vi_ba as tvb
from orb_slam3_fast_tpu_torch.utils import convert
from orb_slam3_fast_tpu_torch.utils import lie as tlie
from tests.test_vi_ba import build_vi_problem

torch.set_num_threads(1)

J_CAM = jcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
T_CAM = tcam.Camera.pinhole(400.0, 400.0, 320.0, 240.0)


def tracker_shaped(rng, pad=2):
    """The test's problem with the tracker's shapes: stereo edges on half the
    observations (bf 40), 5% outliers, ``pad`` padded states that repeat
    the newest keyframe (fixed, observing its landmarks again), 3 invalid
    landmarks and 50 padded observations."""
    prob, R_gt, p_gt, v_gt, xw_gt = build_vi_problem(rng, n_kf=6, n_lm=150)
    K = prob.R_wb.shape[0]
    kf, lm = np.asarray(prob.obs_kf), np.asarray(prob.obs_lm)
    uv = np.asarray(prob.obs_uv).copy()
    R_bw = np.transpose(R_gt, (0, 2, 1))
    xc = np.einsum("oij,oj->oi", R_bw[kf], xw_gt[lm] - p_gt[kf])
    st = (rng.uniform(size=len(kf)) < 0.5) & (xc[:, 2] > 0.5)
    uv[st, 2] = uv[st, 0] - 40.0 / xc[st, 2] + rng.normal(0, 0.3, st.sum())
    n_out = len(kf) // 20
    out = rng.choice(len(kf), n_out, replace=False)
    uv[out, :2] += rng.uniform(15, 30, (n_out, 2))
    last = np.nonzero(kf == K - 1)[0]
    pads = [np.full(len(last), K + i, np.int32) for i in range(pad)]
    kf2 = np.concatenate([kf] + pads + [np.zeros(50, np.int32)])
    lm2 = np.concatenate([lm] + [lm[last]] * pad + [np.zeros(50, np.int32)])
    rep = lambda a, fill=None: np.concatenate([a] + [a[last]] * pad + [np.full((50,) + a.shape[1:], fill, a.dtype)])
    lm_valid = np.ones(prob.xw.shape[0], bool)
    lm_valid[[3, 17, 40]] = False
    stack = lambda a: jnp.concatenate([a, jnp.repeat(a[-1:], pad, 0)])
    return jvb.VIBAProblem(
        R_wb=stack(prob.R_wb), p_wb=stack(prob.p_wb), v_w=stack(prob.v_w), bias=stack(prob.bias),
        state_fixed=jnp.asarray(np.arange(K + pad) == 0) | jnp.asarray(np.arange(K + pad) >= K),
        xw=prob.xw, lm_valid=jnp.asarray(lm_valid), obs_kf=jnp.asarray(kf2), obs_lm=jnp.asarray(lm2),
        obs_uv=jnp.asarray(rep(uv.astype(np.float32), -1.0)), obs_inv_sigma2=jnp.asarray(
            rep(np.asarray(prob.obs_inv_sigma2), 1.0)), obs_is_stereo=jnp.asarray(rep(st, False)),
        obs_valid=jnp.asarray(rep(np.asarray(prob.obs_valid), False)),
        edge_i=jnp.asarray(np.r_[np.arange(K - 1), np.zeros(pad)].astype(np.int32)),
        edge_j=jnp.asarray(np.r_[np.arange(1, K), np.ones(pad)].astype(np.int32)),
        edge_valid=jnp.asarray(np.arange(K - 1 + pad) < K - 1),
        preint=jax.tree.map(stack, prob.preint),
    ), p_gt


@pytest.mark.parametrize("case", ["test", "tracker"])
def test_vi_bundle_adjust_matches_reference(case):
    """Float32 LM in two frameworks (4 + 8 iterations, a 15K float32 LU
    each): positions within 2e-3 m, rotation entries within 2e-4,
    velocities within 1e-2 m/s, biases within 1e-3, landmarks within 1e-2
    m, at most 1% of the observations classified otherwise."""
    rng = np.random.default_rng(7)
    if case == "test":
        prob, R_gt, p_gt, v_gt, xw_gt = build_vi_problem(rng)
        bf, Tj = 0.0, jlie.SE3.identity()
    else:
        prob, p_gt = tracker_shaped(rng)
        bf = 40.0
        Tj = jlie.SE3(jlie.so3_exp(jnp.asarray([0.01, -0.02, 0.015])), jnp.asarray([0.03, 0.0, -0.02]))
    Tt = tlie.SE3(torch.tensor(np.asarray(Tj.R)), torch.tensor(np.asarray(Tj.t)))
    out_j = jvb.vi_bundle_adjust(J_CAM, jnp.float32(bf), Tj, prob)
    out_t = tvb.vi_bundle_adjust(T_CAM, bf, Tt, convert.inertial_to_torch(prob))
    names = ("R", "p", "v", "bias", "xw")
    tols = (2e-4, 2e-3, 1e-2, 1e-3, 1e-2)
    for name, tol, a, b in zip(names, tols, out_t[:5], out_j[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, err_msg=name)
    assert np.mean(out_t[5].numpy() != np.asarray(out_j[5])) <= 0.01
    if case == "test":  # the tracker-shaped data carry no camera offset: only there is the truth the optimum
        assert np.linalg.norm(out_t[1].numpy() - p_gt, axis=1).max() < 0.01


def test_csr_orders_observations():
    """The kernel's per-landmark and per-state lists: valid observations
    only, grouped by key, the state lists in landmark order."""
    obs_kf = torch.tensor([1, 0, 1, 0, 2, 1], dtype=torch.int32)
    obs_lm = torch.tensor([5, 3, 2, 5, 3, 2], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, False, True])
    ptr, idx = tvb._csr(obs_lm, None, 6, valid)
    assert ptr.tolist() == [0, 0, 0, 2, 3, 3, 5]
    assert idx.tolist() == [2, 5, 1, 0, 3]
    ptr, idx = tvb._csr(obs_kf, obs_lm, 3, valid)
    assert ptr.tolist() == [0, 2, 5, 5]
    assert idx.tolist() == [1, 3, 2, 5, 0]
    assert tvb.vi_ba_scratch_doubles(16, 2048, 8192, 15) > 240 * 240


def test_state_edges_list_each_states_edges_in_order():
    """Kernel Y's per-state edge lists: each state's valid edges in edge
    order, an edge with i == j once, invalid edges nowhere; any number of
    states (K = 128, the bucket of a full BA over 65+ keyframes)."""
    ei = torch.tensor([3, 0, 1, 2, 0], dtype=torch.int32)
    ej = torch.tensor([0, 1, 1, 3, 1], dtype=torch.int32)
    ev = torch.tensor([True, True, True, True, False])
    ptr, edges = tvb._state_edges(ei, ej, ev, 4)
    assert ptr.tolist() == [0, 2, 4, 5, 7]
    assert edges.tolist() == [0, 1, 1, 2, 3, 0, 3]
    K = 128
    ei = torch.arange(K - 1, dtype=torch.int32)
    ptr, edges = tvb._state_edges(ei, ei + 1, ei < 99, K)
    assert ptr[-1] == 2 * 99 and ptr[100:].tolist() == [198] * 29
    assert [edges[ptr[k]:ptr[k + 1]].tolist() for k in (0, 50, 99)] == [[0], [49, 50], [98]]

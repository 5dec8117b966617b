"""Port parity for the evaluation metrics and drivers: romp_tpu_torch.eval
against romp_tpu.eval on the same seeded numpy inputs.

The tensor metrics run in float64 on both sides (JAX under
`jax.enable_x64`), held to 1e-10 of max|ref|; the host-side ones (ATE,
PCRD, age groups) and the drivers over them must give equal outputs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romp_tpu.eval import drivers as jdrv
from romp_tpu.eval import metrics as jm
from romp_tpu_torch.eval import drivers as tdrv
from romp_tpu_torch.eval import metrics as tm

torch.set_num_threads(2)


def _pose_pairs(seed=0, N=6, J=24, noise=0.08):
    """GT joints (N, J, 3) in meters and predictions near them, some
    joints within the PCK / AUC thresholds and some outside."""
    rng = np.random.RandomState(seed)
    gt = rng.randn(N, J, 3) * 0.4
    pred = gt + rng.randn(N, J, 3) * noise
    return gt, pred


def _similar(gt):
    """A rotated, scaled and shifted copy of gt plus noise: PA-MPJPE's
    alignment has real work to do."""
    rng = np.random.RandomState(9)
    th = 0.6
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    return 1.3 * gt @ R.T + np.array([0.2, -0.1, 3.0]) \
        + rng.randn(*gt.shape) * 0.02


CASES = {
    "mpjpe": lambda m, g, p: m.mpjpe(g, p),
    "mpjpe_aligned": lambda m, g, p: m.mpjpe(g, p, align_inds=(2, 5)),
    "pa_mpjpe": lambda m, g, p: m.pa_mpjpe(g, p),
    "pve": lambda m, g, p: m.pve(g, p),
    "pck": lambda m, g, p: m.pck(g, p),
    "pck_50": lambda m, g, p: m.pck(g, p, thresh_mm=50.0),
    "auc": lambda m, g, p: m.auc(g, p),
    "acceleration_error": lambda m, g, p: m.acceleration_error(g, p),
}


# pck and auc are shares of joints (and thresholds) under a threshold:
# JAX takes the mean of a boolean array as float32 even with x64 on, so
# their counts (share x joints x thresholds) are compared, and must be equal
COUNTED = {"pck": 24, "pck_50": 24, "auc": 24 * 20}


@pytest.mark.parametrize("similar", [False, True], ids=["noisy", "similar"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_metrics_match_jax_in_f64(name, similar):
    gt, pred = _pose_pairs()
    if similar:
        pred = _similar(gt)
    with jax.enable_x64(True):
        ref = np.asarray(CASES[name](jm, jnp.asarray(gt), jnp.asarray(pred)))
    ours = CASES[name](tm, torch.from_numpy(gt), torch.from_numpy(pred))
    assert ours.dtype == torch.float64
    ours = ours.numpy()
    assert ours.shape == ref.shape
    if name in COUNTED:
        n = COUNTED[name]
        np.testing.assert_array_equal(np.rint(ours * n), np.rint(ref * n))
        if not similar:
            assert 0 < ours.mean() < 1     # the fixture straddles the bar
        return
    assert ref.dtype == np.float64
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert np.abs(ours - ref).max() <= 1e-10 * scale, (ours, ref)


def test_evaluate_matched_pairs_matches_jax_in_f64():
    gt, pred = _pose_pairs(seed=1, N=5, J=54)
    gv, pv = _pose_pairs(seed=2, N=5, J=300)
    with jax.enable_x64(True):
        ref = jm.evaluate_matched_pairs(gt, pred, gv, pv)
    ours = tm.evaluate_matched_pairs(gt, pred, gv, pv)
    assert set(ours) == set(ref) == {"mpjpe", "pampjpe", "pck", "auc", "pve"}
    for k in ("mpjpe", "pampjpe", "pve"):
        assert abs(ours[k] - ref[k]) <= 1e-10 * max(abs(ref[k]), 1e-30), k
    for k in ("pck", "auc"):               # shares of counts, f32 in JAX
        assert abs(ours[k] - ref[k]) <= 1e-5 * abs(ref[k]), k


def test_host_metrics_equal_jax():
    rng = np.random.RandomState(4)
    gt = np.cumsum(rng.randn(20, 3) * 0.1, axis=0)
    pr = gt @ np.diag([1.0, -1.0, -1.0]) * 1.2 + 0.3 + rng.randn(20, 3) * .05
    for align in (True, False):
        assert tm.ate(gt, pr, align) == jm.ate(gt, pr, align)
    depths = rng.rand(6) * 4
    order = np.sign(rng.randn(6, 6))
    order[rng.rand(6, 6) < 0.3] = np.nan
    order[0, 1] = 0.0
    for eq in (0.2, 1.0):
        assert tm.relative_depth_accuracy(depths, order, eq) == \
            jm.relative_depth_accuracy(depths, order, eq)
    kid = rng.rand(40) * 1.2 - 0.1
    groups = rng.randint(0, 4, 40)
    groups[groups == 1] = 0                     # teen: no GT -> nan
    a, b = tm.age_group_accuracy(kid, groups), \
        jm.age_group_accuracy(kid, groups)
    np.testing.assert_array_equal(list(a.values()), list(b.values()))
    assert list(a) == list(b)


def _mesh_samples(seed, n=4):
    """Images with 1-3 GT persons, and a stand-in for the python API that
    returns shuffled, noisy detections (one missing, one spurious)."""
    rng = np.random.RandomState(seed)
    samples, outs = [], []
    for i in range(n):
        P = 1 + i % 3
        centers = rng.rand(P, 2) * 400
        kp3d = rng.randn(P, 54, 3) * 0.3
        verts = rng.randn(P, 100, 3) * 0.3
        samples.append({"image": np.zeros((8, 8, 3), np.uint8),
                        "gt_centers": centers, "gt_kp3d": kp3d,
                        "gt_verts": verts,
                        "depth_ordering": np.sign(rng.randn(P, P)),
                        "age_groups": rng.randint(0, 4, P)})
        order = rng.permutation(P)[:max(P - (i == 2), 1)]
        K = len(order) + 1
        pj2d = rng.rand(K, 71, 2) * 400
        pj2d[:len(order), :24] = (centers[order][:, None]
                                  + rng.randn(len(order), 24, 2) * 3)
        joints = rng.randn(K, 71, 3) * 0.3
        joints[:len(order), :54] = kp3d[order] + rng.randn(
            len(order), 54, 3) * 0.05
        outs.append({"pj2d_org": pj2d, "joints": joints,
                     "verts": rng.randn(K, 100, 3) * 0.3,
                     "cam_trans": rng.randn(K, 3) + [0, 0, 5],
                     "smpl_betas": rng.rand(K, 11)})
    return samples, outs


def _runner(outs):
    it = iter(outs)
    return lambda image: next(it)


def test_drivers_equal_jax():
    samples, outs = _mesh_samples(0)
    a = tdrv.evaluate_mesh_dataset(_runner(outs), samples)
    with jax.enable_x64(True):     # the port keeps the f64 inputs' dtype
        b = jdrv.evaluate_mesh_dataset(_runner(outs), samples)
    assert set(a) == set(b)
    for k in b:                            # pck, auc: f32 in JAX, as above
        tol = 1e-5 if k in ("pck", "auc") else 1e-10
        assert abs(a[k] - b[k]) <= tol * max(abs(b[k]), 1e-30), k
    a = tdrv.evaluate_relative_human(_runner(outs), samples)
    b = jdrv.evaluate_relative_human(_runner(outs), samples)
    np.testing.assert_array_equal(list(a.values()), list(b.values()))
    assert list(a) == list(b)
    rng = np.random.RandomState(2)
    gtc, prc = rng.rand(5, 2) * 100, rng.rand(4, 2) * 100
    for dist in (10.0, 100.0):
        assert tdrv.match_by_center(gtc, prc, dist) == \
            jdrv.match_by_center(gtc, prc, dist)


def test_sequence_tracking_driver_equals_jax():
    rng = np.random.RandomState(5)
    gt, pred = {}, {}
    for f in range(8):
        pos = np.array([[0.0, 0.0, 3.0], [1.0, 0.0, 4.0]]) + 0.1 * f
        gt[f] = (np.array([1, 2]), pos)
        ids = np.array([7, 8]) if f < 5 else np.array([8, 7])   # a switch
        pred[f] = (ids, pos + rng.randn(2, 3) * 0.1)
    a = tdrv.evaluate_sequence_tracking(gt, pred)
    b = jdrv.evaluate_sequence_tracking(gt, pred)
    assert list(a) == list(b)
    np.testing.assert_array_equal(list(a.values()), list(b.values()))

"""The port's accuracy loop (`romp_tpu_torch/eval/convergence.py`) against
`scripts/convergence.py`: the same scenes from the same seeds, and the
train -> rotating checkpoints -> official-protocol scoring chain run end
to end on the CPU at a tiny budget (ROMP, BEV and TRACE)."""
import importlib.util
import json
import os.path as osp

import numpy as np
import pytest
import torch

from romp_tpu_torch.eval import convergence as tconv

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

torch.set_num_threads(2)


def _load_jax_convergence():
    spec = importlib.util.spec_from_file_location(
        "convergence", osp.join(REPO, "scripts", "convergence.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jconv():
    return _load_jax_convergence()


def _close(ours, ref, what, tol=1e-5):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert np.abs(ours - ref).max() <= tol * scale, what


@pytest.mark.parametrize("input_size", [64, 128])
def test_make_scenes_match_jax(jconv, input_size):
    ref, ref_thetas = jconv.make_scenes(6, seed=97, input_size=input_size)
    ours, thetas = tconv.make_scenes(6, seed=97, input_size=input_size)
    np.testing.assert_array_equal(thetas, ref_thetas)
    assert list(ours) == list(ref)
    for k in ref:
        if k in ("kp2d_gt", "kp3d_gt", "image"):
            _close(ours[k], ref[k], k)
        else:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_make_bev_scenes_match_jax(jconv):
    ref, ref_annots = jconv.make_bev_scenes(5, seed=11)
    ours, annots = tconv.make_bev_scenes(5, seed=11)
    assert list(ours) == list(ref)
    for k in ref:
        if k in ("kp2d_gt", "kp3d_gt", "image"):
            _close(ours[k], ref[k], k)
        else:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert list(annots) == list(ref_annots)
    for name in ref_annots:
        for a, b in zip(annots[name], ref_annots[name]):
            assert (a["bbox"], a["depth_id"], a["age"]) == \
                (b["bbox"], b["depth_id"], b["age"])
            _close(a["kp2d"], b["kp2d"], name)


def test_make_trace_scenes_match_jax(jconv):
    ref, ref_annots = jconv.make_trace_scenes(3, seed=97)
    ours, annots = tconv.make_trace_scenes(3, seed=97)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert list(annots) == list(ref_annots)
    for name in ref_annots:
        for k in ref_annots[name]:
            np.testing.assert_array_equal(annots[name][k],
                                          ref_annots[name][k])


def _finite(rows, keys):
    for k in keys:
        assert len(rows[k]) == len(rows["steps"]), k
        assert np.isfinite(rows[k]).all(), (k, rows[k])


def test_romp_chain_on_cpu(tmp_path):
    """The tier-1 mechanics run: hrnet32_tiny at 64x64, 8 steps, a
    checkpoint every 4, 8 train / 4 held-out scenes. Two checkpoints are
    restored and scored by the 3DPW driver with finite metrics, the
    trainer's held-out metric was logged at both and kept the best
    checkpoint, the four precision rows ran, and the standalone
    `--bf16_ckpt` mode merges its rows into the same record."""
    out = tmp_path / "conv.json"
    work = tmp_path / "work"
    tconv.main(["--GPU", "-1", "--steps", "8", "--interval", "4",
                "--n_train", "8", "--n_eval", "4", "--batch", "4",
                "--input_size", "64", "--no_assert", "--workdir", str(work),
                "--out", str(out)])
    payload = json.loads(out.read_text())
    sec = payload["full_scale_64"]
    assert sec["steps"] == [4, 8]
    _finite(sec, ("MPJPE", "MPJPE_PA", "PCK", "AUC", "MPJAE", "MPJAE_PA"))
    assert sec["device"] == "cpu" and sec["s_per_step"] > 0
    assert set(sec["bf16_on_trained"]) == {"mixed", "bf16", "mixed_fused",
                                           "bf16_fused"}
    for row in sec["bf16_on_trained"].values():
        assert 0.0 <= row["top1_center_agreement"] <= 1.0
        assert np.isfinite(row["conf_max_delta"])
    logged = [json.loads(line) for line in
              (work / "ckpt" / "train_log.jsonl").read_text().splitlines()]
    vals = [r for r in logged if "val" in r]
    assert [r["step"] for r in vals] == [4, 8]
    assert sec["best_val_pampjpe"] == min(r["val"]["pampjpe"] for r in vals)
    assert (work / "ckpt" / "best.npz").exists()
    # the live state scored in the loop equals its restored checkpoint's
    # score: the checkpoint round trip is exact
    np.testing.assert_allclose([r["val"]["mpjpe"] for r in vals],
                               sec["MPJPE"], atol=1e-3)

    tconv.main(["--GPU", "-1", "--input_size", "64", "--n_eval", "4",
                "--bf16_ckpt", str(work / "ckpt" / "step_00000008.npz"),
                "--workdir", str(tmp_path / "work2"), "--out", str(out)])
    payload = json.loads(out.read_text())
    assert payload["bf16_on_trained_cpu"] == sec["bf16_on_trained"]


def test_bev_chain_on_cpu(tmp_path):
    """BEV's chain at a tiny budget: the det-only phase then the full
    objective, rotating checkpoints, Relative Human scoring of each."""
    out = tmp_path / "conv.json"
    rows = tconv.main(["--model", "bev", "--GPU", "-1", "--steps", "4",
                       "--interval", "2", "--n_train", "4", "--n_eval", "2",
                       "--batch", "2", "--no_assert",
                       "--workdir", str(tmp_path / "work"),
                       "--out", str(out)])
    sec = json.loads(out.read_text())["bev"]
    assert sec["steps"] == rows["steps"] == [2, 4]
    _finite(sec, ("mPCKh", "PCRD_0.2", "age_acc"))


def test_trace_chain_on_cpu(tmp_path):
    """TRACE's chain at a tiny budget: two train steps, one checkpoint,
    maps_and_detect -> collect_clip -> DynaCam ATE / APE on two held-out
    sequences."""
    out = tmp_path / "conv.json"
    tconv.main(["--model", "trace", "--GPU", "-1", "--steps", "2",
                "--interval", "2", "--n_train", "2", "--n_eval", "2",
                "--batch", "1", "--no_assert",
                "--workdir", str(tmp_path / "work"), "--out", str(out)])
    sec = json.loads(out.read_text())["trace"]
    assert sec["steps"] == [2]
    _finite(sec, ("ATE", "APE"))


def test_entry_point_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="--GPU -1"):
        tconv.main(["--steps", "1"])


@pytest.mark.slow
def test_romp_chain_at_jax_fixture_sizes(tmp_path):
    """tests/test_convergence.py's fixture budget (128x128, 8 steps,
    interval 4, 8 / 4 scenes, batch 4). JAX's seeded weights improve over
    those 8 steps (853 -> 404 mm); the port's, from another generator, do
    not yet (373 -> 385 on the CPU: 8 steps of a 40-step warmup), so the
    improvement is asserted on the card's full budget (PERF.md), and here
    the chain's output: two scored checkpoints, finite metrics."""
    out = tmp_path / "conv.json"
    tconv.main(["--GPU", "-1", "--steps", "8", "--interval", "4",
                "--n_train", "8", "--n_eval", "4", "--batch", "4",
                "--no_assert", "--workdir", str(tmp_path / "work"),
                "--out", str(out)])
    sec = json.loads(out.read_text())["romp"]
    assert sec["steps"] == [4, 8]
    _finite(sec, ("MPJPE", "MPJPE_PA", "PCK", "AUC", "MPJAE", "MPJAE_PA"))

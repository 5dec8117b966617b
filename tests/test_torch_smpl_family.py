"""Port parity for the SMPL-family extras (SMPL-X / FLAME / MANO):
romp_tpu_torch.smpl.family against romp_tpu.smpl.family on the same
synthetic assets at the real shapes, the packers on official-layout files,
and the JAX tests' own checks (`tests/test_smpl_family.py`) on the port."""
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from romp_tpu.smpl import family as jf
from romp_tpu_torch.ops.rotations import axis_angle_to_matrix
from romp_tpu_torch.smpl import family as tf

torch.set_num_threads(2)
KINDS = ("smplx", "flame", "mano")
# (V, J) of the real models
SHAPES = {"smplx": (10475, 55), "flame": (5023, 5), "mano": (778, 16)}


@pytest.fixture(scope="module")
def assets():
    """Each kind's synthetic assets from the port, checked equal to JAX's
    (the port's numpy copy must draw the same arrays)."""
    out = {}
    for kind in KINDS:
        ours, ref = (m.synthetic_family_assets(kind, seed=0) for m in (tf, jf))
        for field in ("v_template", "shapedirs", "posedirs", "J_regressor",
                      "parents", "lbs_weights", "faces", "lmk_faces_idx",
                      "lmk_bary_coords", "hands_components", "hands_mean"):
            a, b = getattr(ours, field), getattr(ref, field)
            assert (a is None) == (b is None), field
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=field)
        out[kind] = ours
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(J, B=4, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 10).astype(np.float32),
            (rng.randn(B, J * 3) * 0.3).astype(np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_family_forward_matches_jax(assets, kind):
    """Verts and joints at the real shapes against JAX's, f32: 1e-5 of
    max|ref| (both sides round the same f32 blend-shape and chain
    products in other orders; measured about 2e-7)."""
    a = assets[kind]
    model = tf.FamilyModel(a, device="cpu")
    assert (model.v_template.shape[0], model.num_joints) == SHAPES[kind]
    betas, pose = _inputs(model.num_joints)
    jv, jj = jf.family_forward(jf.FamilyModel.from_assets(a),
                               jnp.asarray(betas), jnp.asarray(pose))
    tv, tj = tf.family_forward(model, torch.from_numpy(betas),
                               torch.from_numpy(pose))
    assert tv.shape == (4, SHAPES[kind][0], 3) and tj.dtype == torch.float32
    assert _rel(tv, jv) <= 1e-5 and _rel(tj, jj) <= 1e-5


@pytest.mark.parametrize("kind", ["smplx", "flame"])
def test_vertices_to_landmarks_matches_jax(assets, kind):
    """The barycentric landmarks of the same vertices: 1e-6 of max|ref|
    (three products and a sum per coordinate)."""
    a = assets[kind]
    verts = np.random.RandomState(2).randn(3, a.v_template.shape[0], 3
                                           ).astype(np.float32)
    ref = jf.vertices_to_landmarks(
        jnp.asarray(verts), jnp.asarray(a.faces),
        jnp.asarray(a.lmk_faces_idx), jnp.asarray(a.lmk_bary_coords))
    model = tf.FamilyModel(a)
    ours = tf.vertices_to_landmarks(torch.from_numpy(verts), model.faces,
                                    model.lmk_faces_idx,
                                    model.lmk_bary_coords)
    assert ours.shape == (3, 51, 3)
    assert _rel(ours, ref) <= 1e-6


def test_mano_pose_from_pca_matches_jax(assets):
    """1e-6 of max|ref|: one f32 product of at most 45 terms."""
    a = assets["mano"]
    rng = np.random.RandomState(3)
    go = rng.randn(2, 3).astype(np.float32)
    coeffs = rng.randn(2, 12).astype(np.float32)
    ref = jf.mano_pose_from_pca(jf.FamilyModel.from_assets(a),
                                jnp.asarray(go), jnp.asarray(coeffs))
    ours = tf.mano_pose_from_pca(tf.FamilyModel(a), torch.from_numpy(go),
                                 torch.from_numpy(coeffs))
    assert ours.shape == (2, 48)
    assert _rel(ours, ref) <= 1e-6


def _official(rng, V, J, shape_space, n_expr):
    kin = np.zeros((2, J), np.int64)
    kin[0, 0] = 2 ** 32 - 1
    for j in range(1, J):
        kin[0, j] = rng.randint(0, j)
    return {
        "v_template": rng.randn(V, 3).astype(np.float64),
        "shapedirs": rng.randn(V, 3, shape_space + n_expr),
        "posedirs": rng.randn(V, 3, (J - 1) * 9),
        "J_regressor": rng.rand(J, V),
        "kintree_table": kin,
        "weights": rng.rand(V, J),
        "f": rng.randint(0, V, (2 * V, 3)),
    }


def test_packers_match_jax(tmp_path):
    """The three packers on one official-layout pickle (SMPL-X's 300 + 100
    shape columns, landmarks, MANO's PCA space): every array equal to what
    JAX's packers make of the same file."""
    rng = np.random.RandomState(0)
    d = _official(rng, 97, 16, 300, 100)
    d["lmk_faces_idx"] = rng.randint(0, len(d["f"]), 51)
    d["lmk_bary_coords"] = rng.rand(51, 3)
    d["hands_components"] = rng.randn(45, 45)
    d["hands_mean"] = rng.randn(45)
    path = str(tmp_path / "official.pkl")
    with open(path, "wb") as f:
        pickle.dump(d, f)
    for name, kw in (("pack_official_smplx", {}),
                     ("pack_official_flame", dict(num_betas=20,
                                                  num_expression=10)),
                     ("pack_official_mano", {})):
        ours = getattr(tf, name)(path, **kw)
        ref = getattr(jf, name)(path, **kw)
        for field, a in vars(ours).items():
            b = getattr(ref, field)
            assert (a is None) == (b is None), (name, field)
            if a is not None:
                assert a.dtype == b.dtype, (name, field)
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {field}")


def test_family_model_buffers_on_the_given_device_and_dtype(assets):
    m = tf.FamilyModel(assets["mano"], device="cpu", dtype=torch.float64)
    assert m.v_template.dtype == torch.float64
    assert m.faces.dtype == torch.int32 and m.lmk_faces_idx is None
    assert m.parent_index.tolist() == list(m.parents[1:])
    assert m.num_betas == 10 and m.num_joints == 16
    verts, joints = tf.family_forward(
        m, torch.zeros(1, 10, dtype=torch.float64),
        torch.zeros(1, 48, dtype=torch.float64))
    assert verts.dtype == torch.float64 and joints.shape == (1, 16, 3)


# --- the JAX tests' checks (tests/test_smpl_family.py) on the port --------

@pytest.mark.parametrize("kind", KINDS)
def test_family_forward_shapes_and_rigidity(assets, kind):
    """Rotating only the root by R maps the whole mesh through R about the
    root joint."""
    model = tf.FamilyModel(assets[kind])
    B, J = 2, model.num_joints
    rng = np.random.RandomState(1)
    betas = torch.from_numpy(rng.randn(B, 10).astype(np.float32))
    pose = torch.from_numpy(rng.randn(B, J * 3).astype(np.float32) * 0.2)
    verts, joints = tf.family_forward(model, betas, pose)
    assert verts.shape == (B, assets[kind].v_template.shape[0], 3)
    assert joints.shape == (B, J, 3)
    assert torch.isfinite(verts).all()

    aa = torch.zeros((B, J * 3))
    aa[:, 1] = 0.7
    v_rot, _ = tf.family_forward(model, betas, aa)
    v_id, j_id = tf.family_forward(model, betas, torch.zeros_like(pose))
    R = axis_angle_to_matrix(aa[:1, :3])[0]
    root = j_id[:, :1]
    np.testing.assert_allclose(v_rot.numpy(), ((v_id - root) @ R.T + root
                                               ).numpy(), atol=1e-4)


def test_flame_landmarks_barycentric(assets):
    a = assets["flame"]
    model = tf.FamilyModel(a)
    verts, _ = tf.family_forward(model, torch.zeros((1, 10)),
                                 torch.zeros((1, model.num_joints * 3)))
    lmk = tf.vertices_to_landmarks(verts, model.faces, model.lmk_faces_idx,
                                   model.lmk_bary_coords)
    assert lmk.shape == (1, 51, 3)
    tri = a.faces[int(a.lmk_faces_idx[0])]
    expect = (verts.numpy()[0, tri] * a.lmk_bary_coords[0][:, None]).sum(0)
    np.testing.assert_allclose(lmk.numpy()[0, 0], expect, atol=1e-6)


def test_mano_pca_pose_space(assets):
    model = tf.FamilyModel(assets["mano"])
    go = torch.from_numpy(np.random.RandomState(0).randn(2, 3)
                          .astype(np.float32))
    coeffs = torch.from_numpy(np.random.RandomState(1).randn(2, 6)
                              .astype(np.float32))
    pose = tf.mano_pose_from_pca(model, go, coeffs)
    assert pose.shape == (2, 48)
    np.testing.assert_allclose(pose[:, :3].numpy(), go.numpy())
    expect = (model.hands_mean + coeffs @ model.hands_components[:6]).numpy()
    np.testing.assert_allclose(pose[:, 3:].numpy(), expect, atol=1e-6)
    p0 = tf.mano_pose_from_pca(model, go, torch.zeros((2, 6)))
    np.testing.assert_allclose(
        p0[:, 3:].numpy(), np.tile(model.hands_mean.numpy(), (2, 1)),
        atol=1e-6)


def test_packers_official_layouts(tmp_path):
    """SMPL-X npz with (V, 3, 400) shapedirs, MANO pkl with PCA, FLAME pkl;
    each packed model runs the forward."""
    rng = np.random.RandomState(0)
    d = _official(rng, 101, 55, 300, 100)
    d["lmk_faces_idx"] = rng.randint(0, len(d["f"]), 51)
    d["lmk_bary_coords"] = rng.rand(51, 3)
    np.savez(tmp_path / "smplx.npz", **d)
    a = tf.pack_official_smplx(str(tmp_path / "smplx.npz"), num_betas=10,
                               num_expression=10)
    assert a.shapedirs.shape == (101, 3, 20)
    assert a.posedirs.shape == (54 * 9, 101 * 3)
    assert a.parents[0] == -1 and a.num_joints == 55
    v, _ = tf.family_forward(tf.FamilyModel(a), torch.zeros((1, 20)),
                             torch.zeros((1, 165)))
    assert v.shape == (1, 101, 3)

    d2 = _official(rng, 78, 16, 10, 0)
    d2["hands_components"] = rng.randn(45, 45)
    d2["hands_mean"] = rng.randn(45)
    with open(tmp_path / "mano.pkl", "wb") as f:
        pickle.dump(d2, f)
    a2 = tf.pack_official_mano(str(tmp_path / "mano.pkl"))
    assert a2.hands_components.shape == (45, 45)
    assert a2.shapedirs.shape == (78, 3, 10)

    d3 = _official(rng, 103, 5, 300, 100)
    with open(tmp_path / "flame.pkl", "wb") as f:
        pickle.dump(d3, f)
    a3 = tf.pack_official_flame(str(tmp_path / "flame.pkl"), num_betas=20,
                                num_expression=10)
    assert a3.shapedirs.shape == (103, 3, 30)
    assert a3.num_joints == 5


def test_family_assets_roundtrip(tmp_path):
    a = tf.synthetic_family_assets("mano", seed=3)
    a.save(str(tmp_path / "mano_assets.npz"))
    b = tf.FamilyAssets.load(str(tmp_path / "mano_assets.npz"))
    for field, x in vars(a).items():
        y = getattr(b, field)
        assert (x is None) == (y is None), field
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=field)
    # JAX's loader reads the port's file
    c = jf.FamilyAssets.load(str(tmp_path / "mano_assets.npz"))
    np.testing.assert_array_equal(c.hands_components, a.hands_components)

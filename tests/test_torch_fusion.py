"""The port's multi-view fusion against the JAX package's, on the CPU.

Both packages get the same seeded NumPy inputs (points, poses, depth maps,
feature maps written to disk):

* ``compute_mapping_torch`` gives ``compute_mapping_jax``'s ``v``, ``u`` and
  ``visible`` exactly, on the fixture scene of ``tests/test_fusion.py``
  (64x48, 500 points), with and without depth, ``cut_bound`` 0 and 2, one
  view or several stacked; and on degenerate points (the camera centre,
  z = 1e-30, z = 0), where the JAX package's answer differs from the NumPy
  reference mapper (ROADMAP.md §3).
* ``MultiViewFuser`` (device ``cpu``) against the JAX ``MultiViewFuser``
  (jitted on the CPU): 5 views, ``views_per_dispatch`` 4 (the JAX step pads
  its last chunk), fp32 and fp16 maps, C = 8 and one C = 768 case:
  ``point_ids`` equal and ``feat_bank`` within 1e-6 relative (fp32 sums in
  the same view order).
* ``save_fused_feature`` with the same seed writes bit-equal ``.npz``
  contents.
* ``fuse_dataset`` (and the CLI) against the JAX ``fuse_dataset`` on
  written ScanNet, Matterport, Replica and nuScenes layouts: the same files,
  ``mask_full`` equal and ``feat`` within one fp16 ulp.
* The view adapters read the same frames, poses, intrinsics and depths.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from openscene_tpu.fusion import datasets as jds
from openscene_tpu.fusion.fuse import MultiViewFuser as JaxFuser
from openscene_tpu.fusion.fuse import save_fused_feature as jax_save
from openscene_tpu.fusion.mapper import (PointCloudToImageMapper,
                                         compute_mapping_jax, make_intrinsic)
from openscene_tpu.fusion.run_fusion import fuse_dataset as jax_fuse_dataset
from openscene_tpu_torch.fusion import datasets as tds
from openscene_tpu_torch.fusion import run_fusion
from openscene_tpu_torch.fusion.fuse import (MultiViewFuser,
                                             save_fused_feature)
from openscene_tpu_torch.fusion.mapper import (INT_CAP,
                                               compute_mapping_torch,
                                               round_to_int32)
from tests.test_fusion import look_at_pose, render_depth, scene  # noqa: F401
from tests.test_torch_unet import _one_thread  # noqa: F401


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _torch_mapping(pose, intr, coords, depth, dim, vis, cb, use_depth=True):
    out = compute_mapping_torch(_t(pose), _t(intr), _t(coords),
                                None if depth is None else _t(depth), dim,
                                vis, cb, use_depth)
    return [a.numpy() for a in out]


def _jax_mapping(pose, intr, coords, depth, dim, vis, cb, use_depth=True):
    out = compute_mapping_jax(np.float32(pose), np.float32(intr),
                              np.float32(coords), np.float32(depth), dim,
                              vis, cb, use_depth)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("cut_bound", [0, 2])
@pytest.mark.parametrize("use_depth", [True, False])
def test_mapping_equals_jax(scene, use_depth, cut_bound):  # noqa: F811
    coords, pose, intrinsic, depth, dim = scene
    W, H = dim
    d = depth if use_depth else np.zeros((H, W), np.float32)
    ref = _jax_mapping(pose, intrinsic[:3, :3], coords, d, dim, 0.1,
                       cut_bound, use_depth)
    got = _torch_mapping(pose, intrinsic[:3, :3], coords, d, dim, 0.1,
                         cut_bound, use_depth)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    assert ref[2].sum() > 50
    # several views stacked in one call give each view's own answer
    pose2 = look_at_pose([1, 5, 1.5], [2, 2, 1])
    d2 = (render_depth(pose2, intrinsic, coords, W, H) if use_depth
          else np.zeros((H, W), np.float32))
    v, u, vis = _torch_mapping(np.stack([pose, pose2]),
                               np.stack([intrinsic[:3, :3]] * 2), coords,
                               np.stack([d, d2]), dim, 0.1, cut_bound,
                               use_depth)
    ref2 = _jax_mapping(pose2, intrinsic[:3, :3], coords, d2, dim, 0.1,
                        cut_bound, use_depth)
    for g, r0, r1 in zip((v, u, vis), ref, ref2):
        assert np.array_equal(g[0], r0) and np.array_equal(g[1], r1)


def test_round_to_int32_matches_xla_cast():
    """NaN -> 0 and saturation on every device; within the cap the values
    are XLA's, half to even."""
    import jax.numpy as jnp
    x = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.5, 3.5, -2.5, 0.5,
                  1e-30, 70.49], np.float32)
    ref = np.asarray(jnp.round(jnp.asarray(x)).astype(jnp.int32))
    got = round_to_int32(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.clip(ref, -INT_CAP, INT_CAP))
    np.testing.assert_array_equal(got[:5], [0, INT_CAP, -INT_CAP, INT_CAP,
                                            -INT_CAP])


# identity pose: camera coordinates are world coordinates
DEGENERATE = np.array([
    [0.0, 0.0, 0.0],      # the camera centre: u = v = 0/0
    [0.0, 0.0, 1e-30],    # on the axis at z = 1e-30: pixel (cy, cx)
    [0.5, 0.2, 1e-30],    # x / z = 5e29: far out of the image
    [0.0, 1.0, 0.0],      # z = 0: u = 0/0, v = +inf
    [-0.3, 0.0, 0.0],     # z = 0: u = -inf, v = 0/0
    [0.2, -0.1, 2.0],     # an ordinary point
    [0.0, 0.0, -1e-30],   # just behind the camera
])


@pytest.mark.parametrize("depth00", [0.0, 2.0, None])
def test_degenerate_points_equal_jax(depth00):
    """The port follows the JAX package; the camera centre is where the JAX
    package departs from the NumPy reference mapper: its NaN pixel becomes
    (0, 0), so with ``cut_bound`` 0 it is visible where ``depth[0, 0]`` is
    0 (missing depth).  The NumPy reference's cast puts it out of bounds."""
    W, H = 64, 48
    intr = make_intrinsic(40.0, 40.0, W / 2, H / 2)
    pose = np.eye(4)
    use_depth = depth00 is not None
    depth = np.full((H, W), 2.0, np.float32)
    depth[24, 32] = 0.0  # missing depth under the axis points
    if use_depth:
        depth[0, 0] = depth00
    d = depth if use_depth else np.zeros((H, W), np.float32)
    ref = _jax_mapping(pose, intr[:3, :3], DEGENERATE, d, (W, H), 0.25, 0,
                       use_depth)
    got = _torch_mapping(pose, intr[:3, :3], DEGENERATE, d, (W, H), 0.25, 0,
                         use_depth)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    with np.errstate(invalid="ignore", divide="ignore"):
        numpy_ref = PointCloudToImageMapper((W, H), 0.25, 0).compute_mapping(
            pose, DEGENERATE, depth if use_depth else None, intr)
    want_centre = depth00 == 0.0
    assert bool(got[2][0]) == want_centre and numpy_ref[0, 2] == 0
    # the other points: the JAX package and NumPy agree
    np.testing.assert_array_equal(got[2][1:], numpy_ref[1:, 2] == 1)
    assert got[2][5] and got[2][1] == (not use_depth)


def _views(coords, intrinsic, W, H, n_views, use_depth):
    eyes = [[2, -3, 1.2], [1, 5, 1.5], [-2, 2, 1.0], [6, 1, 1.8],
            [2, 2, 4.0]]
    views = []
    for i in range(n_views):
        pose = look_at_pose(eyes[i], [2, 2, 1])
        depth = (render_depth(pose, intrinsic, coords, W, H) if use_depth
                 else None)
        views.append((pose, intrinsic[:3, :3], depth))
    return views


def _maps(n, C, H, W, dtype, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((C, H, W)).astype(dtype) for _ in range(n)]


@pytest.mark.parametrize("C,dtype,use_depth", [
    (8, np.float32, True), (8, np.float16, True), (8, np.float32, False),
    (768, np.float16, True)])
def test_fuser_equals_jax(scene, C, dtype, use_depth):  # noqa: F811
    coords, _, intrinsic, _, (W, H) = scene
    views = _views(coords, intrinsic, W, H, 5, use_depth)
    maps = _maps(5, C, H, W, dtype)
    kw = dict(vis_thres=0.1, cut_bound=2, use_depth=use_depth, feat_dim=C,
              views_per_dispatch=4)
    ref_bank, ref_ids = JaxFuser((W, H), **kw).fuse_scene(
        coords, views, lambda i: maps[i])
    bank, ids = MultiViewFuser((W, H), device="cpu", **kw).fuse_scene(
        coords, views, lambda i: maps[i])
    assert bank.dtype == np.float32 and bank.shape == (len(coords), C)
    np.testing.assert_array_equal(ids, ref_ids)
    assert len(ids) > 100
    np.testing.assert_allclose(bank, ref_bank, rtol=1e-6, atol=0)


def test_fuser_steps_do_not_change_the_sums(scene):  # noqa: F811
    """views_per_dispatch only groups the projection: 1, 2, 4 and 8 views a
    step give bit-equal sums and counts."""
    coords, _, intrinsic, _, (W, H) = scene
    views = _views(coords, intrinsic, W, H, 5, True)
    maps = _maps(5, 8, H, W, np.float16)
    outs = [MultiViewFuser((W, H), 0.1, 2, feat_dim=8, views_per_dispatch=k,
                           device="cpu").accumulate(coords, views,
                                                    lambda i: maps[i])
            for k in (1, 2, 4, 8)]
    for s, c in outs[1:]:
        assert torch.equal(s, outs[0][0]) and torch.equal(c, outs[0][1])
    assert outs[0][1].dtype == torch.int32 and int(outs[0][1].max()) > 1


def test_save_fused_feature_same_draws(tmp_path):
    rng = np.random.default_rng(0)
    bank = rng.standard_normal((700, 8)).astype(np.float32)
    ids = np.sort(rng.choice(700, 450, replace=False))
    for saver, out in ((jax_save, "jax"), (save_fused_feature, "torch")):
        saver(bank, ids, 700, str(tmp_path / out), "scene0", 3, 300,
              rng=np.random.default_rng(11))
    _same_blobs(tmp_path / "jax", tmp_path / "torch", ulps=0)


def _same_blobs(ref_dir, got_dir, ulps):
    names = sorted(os.listdir(ref_dir))
    assert names and names == sorted(os.listdir(got_dir))
    for name in names:
        ref, got = np.load(ref_dir / name), np.load(got_dir / name)
        assert sorted(ref.files) == sorted(got.files) == ["feat", "mask_full"]
        assert got["mask_full"].dtype == ref["mask_full"].dtype
        np.testing.assert_array_equal(got["mask_full"], ref["mask_full"])
        assert got["feat"].dtype == ref["feat"].dtype == np.float16
        assert got["feat"].shape == ref["feat"].shape
        if ulps == 0:
            np.testing.assert_array_equal(got["feat"], ref["feat"])
        else:
            np.testing.assert_array_max_ulp(got["feat"], ref["feat"], ulps)
    return names


# ---------------------------------------------------------------------------
# dataset layouts, written once per module
# ---------------------------------------------------------------------------

N_POINTS = 2000
C_FEAT = 8


def _save_depth(path, depth, scale):
    Image.fromarray(np.round(depth * scale).astype(np.uint16)).save(path)


def _write_maps(root, sid, frames, H, W, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(root / "feats" / sid, exist_ok=True)
    for f in frames:
        np.save(root / "feats" / sid / f"{f}.npy",
                rng.standard_normal((C_FEAT, H, W)).astype(np.float32))


def _room(rng, n=N_POINTS):
    return rng.random((n, 3)) * [4, 4, 2]


def _layout_scannet(root, rng):
    spec = jds.SPECS["scannet"]
    W, H = spec.image_dim
    coords = _room(rng)
    sid = "scene0000_00"
    d3 = root / "scannet_3d"
    for split in ("train", "val"):
        os.makedirs(d3 / split)
        np.savez(d3 / split / f"{sid}.npz", coords=coords.astype(np.float32),
                 labels=rng.integers(0, 20, len(coords)))
    d2 = root / "scannet_2d" / sid
    os.makedirs(d2 / "pose")
    os.makedirs(d2 / "depth")
    frames = ["0", "20", "40"]
    for f, eye in zip(frames, ([2, -2, 1.2], [-1, 2, 1.5], [2, 5, 1.0])):
        pose = look_at_pose(eye, [2, 2, 1])
        np.savetxt(d2 / "pose" / f"{f}.txt", pose)
        _save_depth(d2 / "depth" / f"{f}.png",
                    render_depth(pose, jds.SCANNET_INTRINSIC, coords, W, H),
                    spec.depth_scale)
    _write_maps(root, sid, frames, H, W, seed=1)
    return sid


def _layout_matterport(root, rng):
    spec = jds.SPECS["matterport"]
    W, H = spec.image_dim
    coords = _room(rng)
    sid = "B0001_region0"
    d3 = root / "matterport_3d"
    for split in ("train", "val"):
        os.makedirs(d3 / split)
        np.savez(d3 / split / f"{sid}.npz", coords=coords.astype(np.float32),
                 labels=rng.integers(0, 21, len(coords)))
    b = root / "matterport_2d" / "B0001"
    for sub in ("color", "pose", "intrinsic", "depth"):
        os.makedirs(b / sub)
    intr = make_intrinsic(320.0, 320.0, W / 2, H / 2)
    frames = []
    # two cameras inside the region's box, one outside it
    for yaw, eye in enumerate(([1, 1, 1], [3, 2.5, 1.5], [9, 9, 1])):
        name = f"pano_i1_{yaw}"
        frames.append(name)
        pose = look_at_pose(eye, [2, 2, 1])
        Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
            b / "color" / f"{name}.jpg")
        np.savetxt(b / "pose" / f"{name}.txt", pose)
        np.savetxt(b / "intrinsic" / f"{name}.txt", intr)
        _save_depth(b / "depth" / f"pano_d1_{yaw}.png",
                    render_depth(pose, intr, coords, W, H), spec.depth_scale)
    _write_maps(root, sid, frames, H, W, seed=2)
    return sid


def _layout_replica(root, rng):
    spec = jds.SPECS["replica"]
    W, H = spec.image_dim
    coords = _room(rng)
    sid = "room0"
    d3 = root / "replica_3d"
    for split in ("train", "val"):
        os.makedirs(d3 / split)
        np.savez(d3 / split / f"{sid}.npz", coords=coords.astype(np.float32),
                 labels=np.full(len(coords), 255, np.int64))
    d2 = root / "replica_2d" / sid
    os.makedirs(d2 / "pose")
    os.makedirs(d2 / "depth")
    intr = make_intrinsic(300.0, 300.0, W / 2, H / 2)
    np.savetxt(root / "replica_2d" / "intrinsics.txt", intr)
    frames = ["0", "2", "10"]  # read in the order of their numbers
    for f, eye in zip(frames, ([2, -4, 1], [6, 2, 1.3], [-2, 1, 1.1])):
        pose = look_at_pose(eye, [2, 2, 1])
        np.savetxt(d2 / "pose" / f"{f}.txt", pose)
        _save_depth(d2 / "depth" / f"{f}.png",
                    render_depth(pose, intr, coords, W, H), spec.depth_scale)
    _write_maps(root, sid, frames, H, W, seed=3)
    return sid


def _layout_nuscenes(root, rng):
    spec = jds.SPECS["nuscenes"]
    W, H = spec.image_dim
    coords = rng.random((N_POINTS, 3)) * [20, 20, 4] - [10, 10, 2]
    labels = np.full(len(coords), 255, np.int64)
    half = len(coords) // 2
    labels[rng.choice(len(coords), half, replace=False)] = rng.integers(
        0, 16, half)
    sid = "scene0"
    d3 = root / "nuscenes_3d"
    for split in ("train", "val"):
        os.makedirs(d3 / split)
        np.savez(d3 / split / f"{sid}.npz", coords=coords.astype(np.float32),
                 labels=labels)
    d2 = root / "nuscenes_2d" / sid
    os.makedirs(d2 / "pose")
    os.makedirs(d2 / "K")
    intr = make_intrinsic(400.0, 400.0, W / 2, H / 2)
    cams = ["back", "front", "front_left"]
    for cam, eye in zip(cams, ([0, -25, 1], [0, 25, 1], [-25, 3, 1])):
        np.save(d2 / "pose" / f"{cam}.npy", look_at_pose(eye, [0, 0, 0]))
        np.save(d2 / "K" / f"{cam}.npy", intr)
    _write_maps(root, sid, cams, H, W, seed=4)
    return sid


LAYOUTS = {"scannet": _layout_scannet, "matterport": _layout_matterport,
           "replica": _layout_replica, "nuscenes": _layout_nuscenes}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("fusion_layouts")
    rng = np.random.default_rng(0)
    return root, {name: make(root, rng) for name, make in LAYOUTS.items()}


def _fuse_both(layouts, dataset, split, tmp_path):
    root, sids = layouts
    args = (str(root / f"{dataset}_3d" / split), str(root / f"{dataset}_2d"))
    kw = dict(split=split, feat_dir=str(root / "feats"), feat_dim=C_FEAT,
              seed=3)
    jax_fuse_dataset(dataset, args[0], args[1], str(tmp_path / "jax"), **kw)
    run_fusion.fuse_dataset(dataset, args[0], args[1],
                            str(tmp_path / "torch"), device="cpu", **kw)
    return sids[dataset]


@pytest.mark.parametrize("dataset,split", [
    ("scannet", "train"), ("scannet", "val"), ("matterport", "val"),
    ("replica", "train"), ("nuscenes", "train")])
def test_fuse_dataset_equals_jax(layouts, dataset, split, tmp_path):
    """The same files by each dataset's save policy: ScanNet train 5 random
    chunks (the same draws), val one ``_0`` blob, Replica the whole cloud,
    nuScenes one whole-scene blob of the labelled points."""
    sid = _fuse_both(layouts, dataset, split, tmp_path)
    names = _same_blobs(tmp_path / "jax", tmp_path / "torch", ulps=1)
    want = {("scannet", "train"): [f"{sid}_{k}.npz" for k in range(5)],
            ("nuscenes", "train"): [f"{sid}.npz"]}.get(
                (dataset, split), [f"{sid}_0.npz"])
    assert names == want
    assert np.load(tmp_path / "torch" / names[0])["mask_full"].sum() > 100


def test_fusion_cli_equals_fuse_dataset(layouts, tmp_path, capsys):
    """``python -m openscene_tpu_torch.fusion.run_fusion ... --device cpu``;
    a second run skips the scene (idempotent) and ``--process_id_range``
    outside the scene fuses nothing."""
    root, sids = layouts
    args = ["nuscenes", "--data_root", str(root / "nuscenes_3d" / "train"),
            "--data_root_2d", str(root / "nuscenes_2d"),
            "--feat_dir", str(root / "feats"), "--feat_dim", str(C_FEAT),
            "--device", "cpu"]
    run_fusion.main(args + ["--out_dir", str(tmp_path / "cli")])
    run_fusion.main(args + ["--out_dir", str(tmp_path / "cli")])
    run_fusion.main(args + ["--out_dir", str(tmp_path / "none"),
                            "--process_id_range", "1,2"])
    assert "exists, skip" in capsys.readouterr().out
    assert os.listdir(tmp_path / "none") == []
    jax_fuse_dataset("nuscenes", args[2], args[4], str(tmp_path / "jax"),
                     feat_dir=args[6], feat_dim=C_FEAT)
    _same_blobs(tmp_path / "jax", tmp_path / "cli", ulps=1)


def _same_views(ref, got):
    assert len(ref) == len(got) > 0
    for r, g in zip(ref, got):
        assert r[0] == g[0]
        for a, b in zip(r[1:], g[1:]):
            if a is None:
                assert b is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dataset", ["scannet", "matterport", "replica",
                                     "nuscenes"])
def test_view_adapters_equal_jax(layouts, dataset):
    root, sids = layouts
    sid = sids[dataset]
    d2 = root / f"{dataset}_2d"
    if dataset == "scannet":
        views = [list(m.scannet_views(str(d2 / sid), m.SPECS["scannet"]))
                 for m in (jds, tds)]
    elif dataset == "matterport":
        locs = np.load(root / "matterport_3d" / "val" / f"{sid}.npz")[
            "coords"]
        # the cameras inside the region's box; a test region with none
        # inside takes the nearest cameras
        views = [m.matterport_region_views(str(d2 / "B0001"), box,
                                           m.SPECS["matterport"], split)
                 for box, split in ((locs, "train"), (locs + 100, "test"))
                 for m in (jds, tds)]
        assert len(views[0]) == 2 and len(views[2]) == 3
        _same_views(views[2], views[3])
    elif dataset == "replica":
        views = [list(m.replica_views(str(d2 / sid), m.SPECS["replica"]))
                 for m in (jds, tds)]
        assert [v[0] for v in views[0]] == ["0", "2", "10"]
    else:
        views = [list(m.nuscenes_views(str(d2 / sid))) for m in (jds, tds)]
    _same_views(views[0], views[1])
    np.testing.assert_array_equal(tds.SCANNET_INTRINSIC,
                                  jds.SCANNET_INTRINSIC)
    assert ({k: vars(v) for k, v in tds.SPECS.items()}
            == {k: vars(v) for k, v in jds.SPECS.items()})

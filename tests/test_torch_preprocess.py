"""The port's preprocessors and PLY I/O against the JAX package's, on the CPU.

Both packages' functions run on the same inputs, written from a seed, into
separate output folders; every output file must be byte-equal, or its
arrays equal where a file is compressed:

* PLY: ``write_ply_points`` bytes, ``read_ply`` of binary and ASCII files
  with list properties;
* the ScanNet and nuScenes label remappers, the Matterport category tables
  (21/40/80/160 classes, from ``datasets/matterport/category_mapping.tsv``);
* ``process_scannet_scene``, ``process_nuscenes_scene``,
  ``process_replica_scene``, ``process_matterport_region`` (``.npz``
  scenes);
* the Replica, nuScenes and Matterport 2D round trips and the Matterport
  ``.conf`` parser of ``tests/test_preprocess_2d.py``, and the ScanNet
  ``.sens`` export, on 64x48 raw images (the preprocessors resize them to
  their datasets' sizes); the port's view adapters read the results as the
  JAX package's do.
"""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from openscene_tpu.fusion import datasets as jds
from openscene_tpu.preprocess import images_2d as jimg
from openscene_tpu.preprocess import matterport as jmp
from openscene_tpu.preprocess import matterport_2d as jmp2
from openscene_tpu.preprocess import nuscenes_2d as jnu2
from openscene_tpu.preprocess import point_clouds as jpc
from openscene_tpu.preprocess import replica_2d as jre2
from openscene_tpu.preprocess import scannet_2d as jsc2
from openscene_tpu.utils import ply as jply
from openscene_tpu_torch.fusion import datasets as tds
from openscene_tpu_torch.preprocess import matterport as tmp_
from openscene_tpu_torch.preprocess import matterport_2d as tmp2
from openscene_tpu_torch.preprocess import nuscenes_2d as tnu2
from openscene_tpu_torch.preprocess import point_clouds as tpc
from openscene_tpu_torch.preprocess import replica_2d as tre2
from openscene_tpu_torch.preprocess import scannet_2d as tsc2
from openscene_tpu_torch.utils import ply as tply
from tests.test_ply_preprocess import _write_scannet_pair
from tests.test_torch_fusion import _same_views

TSV = os.path.join(os.path.dirname(os.path.dirname(__file__)), "datasets",
                   "matterport", "category_mapping.tsv")
RAW_W, RAW_H = 64, 48


def _same_trees(ref_dir, got_dir):
    """Every file under the two folders byte-equal (``.npz``: arrays equal,
    dtypes too, since zip headers carry times).  Returns the file count."""
    ref_files = sorted(os.path.relpath(os.path.join(d, f), ref_dir)
                       for d, _, fs in os.walk(ref_dir) for f in fs)
    got_files = sorted(os.path.relpath(os.path.join(d, f), got_dir)
                       for d, _, fs in os.walk(got_dir) for f in fs)
    assert ref_files and ref_files == got_files
    for rel in ref_files:
        a, b = os.path.join(ref_dir, rel), os.path.join(got_dir, rel)
        if rel.endswith(".npz"):
            ra, rb = np.load(a), np.load(b)
            assert sorted(ra.files) == sorted(rb.files)
            for k in ra.files:
                assert ra[k].dtype == rb[k].dtype
                np.testing.assert_array_equal(ra[k], rb[k])
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
    return len(ref_files)


def _same_struct(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    for name in a.dtype.names:
        np.testing.assert_array_equal(a[name], b[name])


def _write_ply(path, fmt, vertex, faces=None):
    """A PLY with float xyz, uchar colours, a ushort label and optionally a
    face element (uchar-counted int vertex_indices, int category_id)."""
    n = len(vertex)
    head = ["ply", f"format {fmt} 1.0", f"element vertex {n}",
            "property float x", "property float y", "property float z",
            "property uchar red", "property uchar green",
            "property uchar blue", "property ushort label"]
    if faces is not None:
        head += [f"element face {len(faces[0])}",
                 "property list uchar int vertex_indices",
                 "property int category_id"]
    head.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode("ascii"))
        if fmt == "ascii":
            for row in vertex:
                f.write((" ".join(str(v) for v in row) + "\n").encode())
            if faces is not None:
                for tri, cat in zip(*faces):
                    f.write((f"3 {tri[0]} {tri[1]} {tri[2]} {cat}\n")
                            .encode())
        else:
            f.write(vertex.tobytes())
            if faces is not None:
                for tri, cat in zip(*faces):
                    f.write(struct.pack("<B3ii", 3, *tri, cat))


def _mesh(rng, n=200, n_faces=300, max_cat=40):
    dt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
          ("green", "u1"), ("blue", "u1"), ("label", "<u2")]
    vertex = np.empty(n, dtype=dt)
    for k in ("x", "y", "z"):
        vertex[k] = rng.random(n).astype(np.float32)
    for k in ("red", "green", "blue"):
        vertex[k] = rng.integers(0, 256, n)
    vertex["label"] = rng.integers(0, 41, n)
    tri = rng.integers(0, n, (n_faces, 3)).astype(np.int32)
    cat = rng.integers(0, max_cat, n_faces).astype(np.int32)
    return vertex, (tri, cat)


def test_write_ply_points_bytes_equal(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.random((100, 3)).astype(np.float32)
    cols = rng.random((100, 3))
    for mod, name in ((jply, "j.ply"), (tply, "t.ply")):
        mod.write_ply_points(str(tmp_path / name), pts, cols)
        mod.write_ply_points(str(tmp_path / ("nc_" + name)), pts)
    for a, b in (("j.ply", "t.ply"), ("nc_j.ply", "nc_t.ply")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
    _same_struct(tply.read_ply(str(tmp_path / "t.ply"))["vertex"],
                 jply.read_ply(str(tmp_path / "j.ply"))["vertex"])


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_read_ply_equals_jax(tmp_path, fmt):
    vertex, faces = _mesh(np.random.default_rng(1), n=40, n_faces=30)
    path = str(tmp_path / "mesh.ply")
    _write_ply(path, fmt, vertex, faces)
    ref, got = jply.read_ply(path), tply.read_ply(path)
    assert sorted(ref) == sorted(got) == ["face", "vertex"]
    for k in ref:
        _same_struct(got[k], ref[k])
    np.testing.assert_array_equal(got["face"]["vertex_indices"], faces[0])


@pytest.mark.parametrize("which", ["scannet", "nuscenes"])
def test_remappers_equal_jax(which):
    ref = getattr(jpc, f"{which}_remapper")()
    got = getattr(tpc, f"{which}_remapper")()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("num_classes", [21, 40, 80, 160])
def test_matterport_category_tables_equal_jax(num_classes):
    ref = jmp.category_to_class_table(TSV, num_classes)
    got = tmp_.category_to_class_table(TSV, num_classes)
    np.testing.assert_array_equal(got, ref)
    assert (got != 255).sum() > 20


def _run_both(tmp_path, fn_j, fn_t, *args):
    for fn, out in ((fn_j, "jax"), (fn_t, "torch")):
        os.makedirs(tmp_path / out, exist_ok=True)
        fn(*args, str(tmp_path / out))
    return _same_trees(str(tmp_path / "jax"), str(tmp_path / "torch"))


def test_process_scannet_scene_equals_jax(tmp_path):
    ply, _, _ = _write_scannet_pair(tmp_path, n=300)
    assert _run_both(tmp_path, jpc.process_scannet_scene,
                     tpc.process_scannet_scene, ply) == 1


@pytest.mark.parametrize("export_all", [False, True])
def test_process_nuscenes_scene_equals_jax(tmp_path, export_all):
    rng = np.random.default_rng(2)
    n = 300
    d = tmp_path / "raw" / "scene-0001"
    os.makedirs(d)
    dt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("category", "<i4")]
    v = np.empty(n, dtype=dt)
    for k in ("x", "y", "z"):
        v[k] = rng.random(n) * 40 - 20
    v["category"] = rng.integers(-1, 32, n)
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {n}\nproperty float x\nproperty float y\n"
            "property float z\nproperty int category\nend_header\n")
    with open(d / "scene.ply", "wb") as f:
        f.write(head.encode())
        f.write(v.tobytes())
    np.save(d / "scene-timestamps.npy", rng.integers(0, 3, n))
    _run_both(tmp_path, lambda p, o: jpc.process_nuscenes_scene(
        p, o, export_all), lambda p, o: tpc.process_nuscenes_scene(
        p, o, export_all), str(d / "scene.ply"))


@pytest.mark.parametrize("colors", [True, False])
def test_process_replica_scene_equals_jax(tmp_path, colors):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "room0_mesh.ply")
    if colors:
        tply.write_ply_points(path, rng.random((200, 3)),
                              rng.random((200, 3)))
    else:
        tply.write_ply_points(path, rng.random((200, 3)))
    _run_both(tmp_path, jpc.process_replica_scene, tpc.process_replica_scene,
              path)


def test_process_matterport_region_equals_jax(tmp_path):
    vertex, faces = _mesh(np.random.default_rng(4), max_cat=60)
    path = str(tmp_path / "region3.ply")
    _write_ply(path, "binary_little_endian", vertex, faces)
    table = jmp.category_to_class_table(TSV, 21)
    _run_both(tmp_path, lambda p, o: jpc.process_matterport_region(
        p, o, table), lambda p, o: tpc.process_matterport_region(
        p, o, table), path)
    labels = np.load(tmp_path / "torch" / "region3.npz")["labels"]
    assert (labels != 255).any() and (labels == 255).any()


def _rand_img(rng):
    return rng.integers(0, 255, size=(RAW_H, RAW_W, 3), dtype=np.uint8)


def _rand_depth(rng):
    return rng.integers(100, 5000, size=(RAW_H, RAW_W), dtype=np.uint16)


def test_replica_2d_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    scene = "office0"
    res = tmp_path / "raw" / scene / "results"
    os.makedirs(res)
    n_frames, freq = 25, 10
    for i in range(n_frames):
        jimg.save_color(str(res / f"frame{i:06d}.jpg"), _rand_img(rng))
        jimg.save_depth_u16(str(res / f"depth{i:06d}.png"), _rand_depth(rng))
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    poses[:, 0, 3] = np.arange(n_frames)
    np.savetxt(str(tmp_path / "raw" / scene / "traj.txt"),
               poses.reshape(n_frames, 16))
    for mod, out in ((jre2, "jax"), (tre2, "torch")):
        mod.process_scene(scene, str(tmp_path / "raw"), str(tmp_path / out),
                          freq)
        intr = mod.adjust_intrinsic(mod.make_intrinsic(
            600.0, 600.0, 599.5, 339.5), mod.ORIGINAL_IMG_DIM, mod.IMG_DIM)
        np.savetxt(str(tmp_path / out / "intrinsics.txt"), intr)
    assert _same_trees(str(tmp_path / "jax"), str(tmp_path / "torch")) == 10
    _same_views(
        list(jds.replica_views(str(tmp_path / "jax" / scene),
                               jds.SPECS["replica"])),
        list(tds.replica_views(str(tmp_path / "torch" / scene),
                               tds.SPECS["replica"])))


def test_nuscenes_2d_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    scene = "scene-0001"
    for ts in ("t0001", "t0002"):  # the last timestamp is exported
        for j, cam in enumerate(jnu2.CAM_LOCS):
            d = tmp_path / "raw" / scene / "frames" / ts / cam
            os.makedirs(d)
            jimg.save_color(str(d / "color_image.jpg"), _rand_img(rng))
            pose = np.eye(4)
            pose[1, 3] = j + (ts == "t0002")
            np.savetxt(str(d / "cam2scene.txt"), pose)
            np.savetxt(str(d / "K.txt"), np.array(
                [[1000.0, 0, 800], [0, 1000.0, 450], [0, 0, 1]]))
    for mod, out in ((jnu2, "jax"), (tnu2, "torch")):
        mod.main(["--in_path", str(tmp_path / "raw"), "--out_dir",
                  str(tmp_path / out)])
    assert _same_trees(str(tmp_path / "jax"), str(tmp_path / "torch")) == 18
    views = [list(m.nuscenes_views(str(tmp_path / out / scene)))
             for m, out in ((jds, "jax"), (tds, "torch"))]
    _same_views(*views)
    assert views[1][0][1][1, 3] == 1.0  # back camera of t0002


def _matterport_raw(tmp_path, rng):
    scene = "B0001"
    base = tmp_path / "raw" / scene
    cdir = base / "undistorted_color_images"
    ddir = base / "undistorted_depth_images"
    pdir = base / "undistorted_camera_parameters"
    for d in (cdir, ddir, pdir):
        os.makedirs(d)
    lines = []
    for b in range(2):  # two panos, one intrinsics block each
        K = [500.0 + b, 0, 640, 0, 500.0 + b, 512, 0, 0, 1]
        lines.append("intrinsics_matrix " + " ".join(str(v) for v in K))
        for j in range(6):
            name = f"pano{b}_i1_{j}.jpg"
            pose = np.eye(4)
            pose[0, 3] = float(j + 6 * b)
            vals = " ".join(str(v) for v in pose.reshape(-1))
            lines.append(f"scan pano{b}_d1_{j}.png {name} {vals}")
            jimg.save_color(str(cdir / name), _rand_img(rng))
            jimg.save_depth_u16(str(ddir / f"pano{b}_d1_{j}.png"),
                                _rand_depth(rng))
    with open(pdir / f"{scene}.conf", "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(tmp_path / "scenes.txt", "w") as f:
        f.write(scene + "\n")
    return scene


def test_matterport_2d_equals_jax(tmp_path):
    scene = _matterport_raw(tmp_path, np.random.default_rng(2))
    for mod, out in ((jmp2, "jax"), (tmp2, "torch")):
        mod.main(["--in_path", str(tmp_path / "raw"), "--out_dir",
                  str(tmp_path / out), "--scene_list",
                  str(tmp_path / "scenes.txt")])
    assert _same_trees(str(tmp_path / "jax"), str(tmp_path / "torch")) == 48
    locs = np.array([[-1.0, -1.0, -1.0], [3.5, 1.0, 1.0]])
    _same_views(*[m.matterport_region_views(
        str(tmp_path / out / scene), locs, m.SPECS["matterport"])
        for m, out in ((jds, "jax"), (tds, "torch"))])


def test_matterport_conf_parser_equals_jax(tmp_path):
    _matterport_raw(tmp_path, np.random.default_rng(3))
    conf = str(tmp_path / "raw" / "B0001" / "undistorted_camera_parameters"
               / "B0001.conf")
    ref, got = jmp2.parse_camera_conf(conf), tmp2.parse_camera_conf(conf)
    assert got[0] == ref[0] and len(got[0]) == 12
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)
    assert got[1][0, 0, 0] == 500.0 and got[1][6, 0, 0] == 501.0
    assert (tmp2.depth_name_for("pano0_i1_3.jpg")
            == jmp2.depth_name_for("pano0_i1_3.jpg") == "pano0_d1_3.png")


def _write_sens(path, rng, n_frames=5, w=RAW_W, h=RAW_H):
    """A ``.sens`` v4 file: jpeg colour, zlib ushort depth."""
    import io
    with open(path, "wb") as f:
        f.write(struct.pack("I", 4))
        name = b"synthetic"
        f.write(struct.pack("Q", len(name)) + name)
        for _ in range(4):  # colour/depth intrinsics and extrinsics
            f.write(rng.random((4, 4)).astype(np.float32).tobytes())
        f.write(struct.pack("ii", 2, 1))  # jpeg, zlib_ushort
        f.write(struct.pack("IIII", w, h, w, h))
        f.write(struct.pack("f", 1000.0))
        f.write(struct.pack("Q", n_frames))
        for _ in range(n_frames):
            buf = io.BytesIO()
            Image.fromarray(_rand_img(rng)).save(buf, format="JPEG")
            color = buf.getvalue()
            depth = zlib.compress(_rand_depth(rng).tobytes())
            f.write(rng.random((4, 4)).astype(np.float32).tobytes())
            f.write(struct.pack("QQ", 0, 0))
            f.write(struct.pack("QQ", len(color), len(depth)))
            f.write(color + depth)


def test_scannet_sens_export_equals_jax(tmp_path):
    sens = str(tmp_path / "scene0000_00.sens")
    _write_sens(sens, np.random.default_rng(5))
    counts = [mod.export_scene(sens, str(tmp_path / out), frame_skip=2)
              for mod, out in ((jsc2, "jax"), (tsc2, "torch"))]
    assert counts == [3, 3]
    # colour, depth and pose of frames 0, 2, 4 and the intrinsics
    assert _same_trees(str(tmp_path / "jax"), str(tmp_path / "torch")) == 10
    ref, got = jsc2.SensStream(sens), tsc2.SensStream(sens)
    try:
        for a, b in zip(ref.frames(), got.frames()):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:] == b[1:]
    finally:
        ref.close()
        got.close()

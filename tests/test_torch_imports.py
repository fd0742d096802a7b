"""Import discipline and device rules of the port.

* Every module of ``openscene_tpu_torch``, and ``chip_smoke.py``, imports in
  a fresh interpreter whose meta path refuses ``jax``, ``jaxlib``, ``flax``,
  ``optax``, ``msgpack`` and ``openscene_tpu``: the port imports none of
  them.  Importing the package tunes the host allocator
  (``utils/hostmem.py``), as the JAX package's import does.
* With ``device="cpu"`` nothing touches another device.
* Asking for CUDA, explicitly or by default, without CUDA raises, and a
  kernel wrapper given a tensor that is neither on the CPU nor on CUDA
  raises instead of taking the plain version.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openscene_tpu_torch import device as device_mod
from openscene_tpu_torch.sparse import _build
from openscene_tpu_torch.sparse.edge_conv import (down_conv_bwd,
                                                  down_conv_fwd, up_conv_bwd)
from openscene_tpu_torch.sparse.stencil_conv import (stencil_conv_bwd,
                                                     stencil_conv_fwd)
from openscene_tpu_torch.sparse.types import DownPlan, EdgeGroups, EdgeSkip
from tests.test_torch_unet import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = r'''
import importlib, importlib.abc, importlib.util, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "openscene_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import openscene_tpu_torch
names = []
for m in pkgutil.walk_packages(openscene_tpu_torch.__path__,
                               "openscene_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
from openscene_tpu_torch.utils import hostmem
assert hostmem._done, "importing the package did not call warm_malloc"
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print(" ".join(names))
'''


def test_port_imports_no_jax_and_no_openscene_tpu():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    names = proc.stdout.split()  # every module was imported
    assert len(names) >= 60
    for mod in ("runtime.distill", "runtime.evaluate", "data.batch",
                "utils.train_utils", "sparse.edge_conv",
                "sparse.stencil_conv", "sparse.ops", "convert",
                "sparse.geometry_device", "sparse.grid", "sparse.pack",
                "scripts.dev_bench_ops", "scripts.dev_pack_bench",
                "scripts.dev_up_tiles", "scripts.timing",
                "runtime.train_seg", "runtime.eval_seg", "sparse.native",
                "utils.hostmem", "utils.flax_msgpack", "fusion.mapper",
                "fusion.fuse", "fusion.datasets", "fusion.run_fusion",
                "utils.ply", "preprocess.point_clouds",
                "preprocess.scannet_2d", "parallel.mesh", "parallel.launch",
                "data.sharded"):
        assert "openscene_tpu_torch." + mod in names


def test_cpu_forward_touches_no_other_device():
    from openscene_tpu_torch.models import MinkUNet
    from openscene_tpu_torch.sparse.geometry import (GeometryCaps,
                                                     build_unet_geometry,
                                                     geometry_to_device)
    coords = np.array([[0, x, y, z] for x in range(6) for y in range(6)
                       for z in range(2)], np.int32)
    geo = build_unet_geometry(coords, caps=GeometryCaps(
        cap0=128, fixed=(128, 64, 64, 64, 64)))
    dev = device_mod.resolve_device("cpu")
    assert dev == torch.device("cpu")
    model = MinkUNet(3, 8, "MinkUNet14A",
                     generator=torch.Generator().manual_seed(0)).eval()
    x = torch.zeros((geo.levels[0].cap, 3), dtype=torch.bfloat16)
    x[:len(coords)] = 1
    with torch.no_grad():
        out = model(x, geometry_to_device(geo, dev), constant_input=True)
    assert out.device == dev and torch.isfinite(out).all()
    assert not torch.cuda.is_initialized()
    assert stencil_conv_fwd.launches == 0 and down_conv_fwd.launches == 0


@pytest.mark.parametrize("requested", [None, "cuda", "cuda:0"])
def test_cuda_without_cuda_raises(monkeypatch, requested):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        device_mod.resolve_device(requested)


def test_evaluator_defaults_to_cuda(monkeypatch):
    from openscene_tpu_torch.config import Config
    from openscene_tpu_torch.runtime.evaluate import ZeroShotEvaluator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        ZeroShotEvaluator(Config(feature_type="fusion"),
                          text_features=np.eye(20, 8, dtype=np.float32))


def test_fusion_defaults_to_cuda(monkeypatch, tmp_path):
    """``MultiViewFuser`` and ``fuse_dataset`` raise without CUDA unless
    given ``device="cpu"``, and on the CPU touch no other device."""
    from openscene_tpu_torch.fusion.fuse import MultiViewFuser
    from openscene_tpu_torch.fusion.run_fusion import fuse_dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        MultiViewFuser((64, 48))
    with pytest.raises(RuntimeError, match="not available"):
        fuse_dataset("nuscenes", str(tmp_path / "3d"), str(tmp_path / "2d"),
                     str(tmp_path / "out"), feat_dir=str(tmp_path))
    assert not (tmp_path / "out").exists()
    fuser = MultiViewFuser((64, 48), feat_dim=4, device="cpu")
    coords = np.random.default_rng(0).random((300, 3)) * [2, 2, 4] - [1, 1, 0]
    pose = np.eye(4)
    intr = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]])
    depth = np.full((48, 64), 3.0, np.float32)
    maps = np.ones((4, 48, 64), np.float16)
    bank, ids = fuser.fuse_scene(coords, [(pose, intr, depth)] * 2,
                                 lambda i: maps * (i + 1))
    assert len(ids) > 0 and np.allclose(bank[ids], 1.5)
    assert fuser.device == torch.device("cpu")
    assert not torch.cuda.is_initialized()


def _meta_down_plan():
    """A DownPlan of meta tensors (32 parents, 64 children) with its
    groups and skip plan, as the device plans carry them."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")
    return DownPlan(fwd=meta(8, 32), child_parent=meta(64),
                    child_offset=meta(64),
                    groups=EdgeGroups(rows=meta(9 * 64), tile_k=meta(9),
                                      count=meta(8)),
                    skip=EdgeSkip(nbr_mask=meta(32), order=meta(32),
                                  tile_mask=meta(1)))


@pytest.mark.parametrize("wrapper,K", [(stencil_conv_fwd, 27),
                                       (down_conv_fwd, 8)])
def test_wrapper_never_falls_back_off_cpu(wrapper, K):
    x = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    w = torch.empty((K, 32, 32), device="meta")
    # the stencil conv takes its fwd plan, the down conv the whole edge plan
    plan = (torch.empty((K, 64), dtype=torch.int32, device="meta")
            if wrapper is stencil_conv_fwd else _meta_down_plan())
    with pytest.raises(ValueError, match="CUDA tensor"):
        wrapper(x, w, plan)
    assert wrapper.launches == 0


@pytest.mark.parametrize("entry", ["train_seg", "eval_seg"])
def test_seg_entry_points_default_to_cuda(monkeypatch, entry):
    from openscene_tpu_torch.config import Config
    from openscene_tpu_torch.runtime import eval_seg, train_seg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        if entry == "train_seg":
            train_seg.SegTrainer(Config())
        else:
            eval_seg.evaluate_seg(Config())


def test_trainer_defaults_to_cuda(monkeypatch):
    from openscene_tpu_torch.config import Config
    from openscene_tpu_torch.runtime import distill
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        distill.DistillTrainer(Config())
    with pytest.raises(RuntimeError, match="not available"):
        distill.main(["epochs", "1"])


@pytest.mark.parametrize("which", ["stencil", "down", "up"])
def test_bwd_wrapper_never_falls_back_off_cpu(which):
    def meta(shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    plan = _meta_down_plan()
    w = torch.empty((8, 32, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        if which == "stencil":
            stencil_conv_bwd(meta((64, 32)), torch.empty((27, 32, 32),
                                                         device="meta"),
                             meta((64, 32)), meta((27, 64), torch.int32),
                             meta((27,), torch.int32))
        elif which == "down":
            down_conv_bwd(meta((64, 32)), w, meta((32, 32)), plan)
        else:
            up_conv_bwd(meta((32, 32)), w, meta((64, 32)), plan)
    assert (stencil_conv_bwd.launches == down_conv_bwd.launches
            == up_conv_bwd.launches == 0)


def test_wgrad_split_covers_the_rows():
    from openscene_tpu_torch.sparse import stencil_conv as sc
    for rows, K, ca, cb in ((300032, 27, 128, 96), (4096, 27, 256, 256),
                            (136704, 8, 32, 32), (1, 8, 8, 8), (33, 27, 8, 8),
                            (1115648, 27, 384, 128)):
        for skip in (False, True):
            bma, bnb, per, splits = sc.wgrad_tiles(rows, K, ca, cb, skip)
            assert per % 32 == 0 and 1 <= splits <= 65535
            assert sc.WGRAD_MIN_ROWS <= per <= sc.WGRAD_MAX_ROWS
            assert (splits - 1) * per < rows <= splits * per
            # tiles of 32..128 channels in 32 x 32 warp tiles, <= 16 warps
            assert bma in sc.WGRAD_TILES and bnb in sc.WGRAD_TILES
            assert bma * bnb // 32 ** 2 <= sc.MAX_WARPS
    # a skip plan leaves most rows of the bound without a pair: its splits
    # are shorter, so the splits that hold rows still fill the card
    assert (sc.wgrad_tiles(300032, 27, 128, 96, True)[2]
            < sc.wgrad_tiles(300032, 27, 128, 96, False)[2])


def test_kernel_build_is_content_hashed(monkeypatch):
    assert _build.sources() == ["gather_gemm_bwd", "gather_gemm_fwd",
                                "pack_pairs_t", "up_conv_fwd"]
    path = _build.library_path("gather_gemm_fwd")
    assert path.startswith(_build.BUILD_DIR)
    assert path == _build.library_path("gather_gemm_fwd")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", os.path.join(REPO, "no-such-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()

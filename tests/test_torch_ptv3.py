"""Point Transformer V3 in the port (``models/ptv3.py``,
``sparse/serialize.py``, ``sparse/patch_attn.py``'s plain path) on the CPU
against the benchmark's plain reference (``benchmark/reference/ptv3.py``),
at tiny widths with patches of 16 and scenes of 10-70 voxels, so that
both padded and short patches occur; seeded random weights.

* the training forward and two distill steps (losses, the first step's
  gradient norms, Adam's change of every leaf), float64 on both sides;
* Morton codes against bit interleaving; consecutive Hilbert codes are
  face neighbours on a full 2^b cube; the ``-trans`` orders; the port's
  Skilling transform equals the reference's bit planes;
* the patch layout (pad, unpad, ``cu_seqlens``) against Pointcept's rule
  written out (``reference.ptv3.padding_and_inverse``);
* DropPath's keep masks equal in the port and the reference;
* the geometry route: a MinkUNet build holds no serialization, a PTv3
  build the same one as the host plans' upload; the route's host uploads
  serialize for PTv3 alone, and the model refuses a geometry without
  one; the trainer's raw step on it; the evaluator's distill mode on a
  tiny PTv3; what the trainers refuse.
"""

import itertools
import statistics

import numpy as np
import pytest
import torch

from benchmark.reference import ptv3 as ref_ptv3
from openscene_tpu_torch.config import Config
from openscene_tpu_torch.data.batch import (_pad_level,
                                            assemble_distill_batch,
                                            merge_caps)
from openscene_tpu_torch.data.loaders import SceneSample
from openscene_tpu_torch.models import ptv3, sparse_unet
from openscene_tpu_torch.runtime import distill as D
from openscene_tpu_torch.runtime import geometry_route as G
from openscene_tpu_torch.sparse import serialize
from openscene_tpu_torch.sparse.geometry import geometry_to_device
from openscene_tpu_torch.sparse.geometry_device import (build_geometry_parts,
                                                        with_host_counts)
from tests.test_torch_distill import (DIM, _trainer_cfg,  # noqa: F401
                                      head32, synth)

TINY = dict(enc_depths=(1, 1, 1, 2, 1), enc_channels=(16, 16, 32, 32, 48),
            enc_num_head=(1, 1, 2, 2, 3), dec_depths=(1, 1, 1, 1),
            dec_channels=(16, 16, 32, 32), dec_num_head=(1, 1, 2, 2),
            patch_size=16)
REF_TINY = {**{k: list(v) for k, v in TINY.items() if k != "patch_size"},
            "patch_size": 16, "mlp_ratio": 4, "drop_path": 0.3,
            "stem_kernel": 5}
OUT = 8
SEED = 123


@pytest.fixture(autouse=True)
def tiny_arch(monkeypatch):
    monkeypatch.setitem(ptv3.ARCHS, "PTv3tiny", ptv3.PTv3Arch(**TINY))
    monkeypatch.setitem(ref_ptv3.ARCHS, "PTv3tiny", REF_TINY)


def _samples(seed, sizes=(10, 40, 70), dim=OUT):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        c = np.unique(rng.integers(0, 9, (4 * n, 3)), axis=0)[:n]
        c = c[rng.permutation(len(c))].astype(np.int32)
        fm = rng.random(len(c)) < 0.8
        out.append(SceneSample(
            c, np.ones((len(c), 3), np.float32), rng.integers(0, 20, len(c)),
            None, rng.standard_normal((int(fm.sum()), dim)).astype(np.float16),
            fm))
    return out


def _bn64(x, mask, num, gamma, beta, running_mean, running_var, *, train,
          momentum=0.1, eps=1e-5):
    """The masked BatchNorm in float64 (the port's computes in fp32)."""
    x, mask = x.double(), mask.double()
    n = float(max(int(num), 1))
    mean = (x * mask).sum(0) / n
    var = (((x - mean) * mask) ** 2).sum(0) / n
    out = ((x - mean) * torch.rsqrt(var + eps) * gamma + beta) * mask
    return out, running_mean, running_var


@pytest.fixture(scope="module")
def setup():
    w = ref_ptv3.make_weights(REF_TINY, 3, OUT, 11, "cpu")
    batches = [assemble_distill_batch(_samples(s, sizes), OUT,
                                      rng=np.random.default_rng(s))
               for s, sizes in ((0, (10, 40, 70)), (1, (30, 65, 12)))]
    return w, batches


def _model(w, dtype=torch.float64):
    m = ptv3.PTv3(3, OUT, "PTv3tiny", seed=SEED)
    m.load_state_dict({k: w[k] for k in m.state_dict()})
    return m.to(dtype)


def _ref_batch(b):
    n = b.num_voxels
    return (torch.from_numpy(b.geo.levels[0].coords[:n]).long(),
            torch.from_numpy(b.feat_3d[:n]).double(),
            torch.from_numpy(b.mask[:n]))


def test_param_shapes_are_the_port_models():
    model = ptv3.PTv3(3, 768, "PTv3m1")
    shapes = ref_ptv3.param_shapes(ref_ptv3.ARCHS["PTv3m1"], 3, 768)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
        == shapes
    assert sum(p.numel() for p in model.parameters()) == 46_203_424


def test_forward_matches_reference(setup, monkeypatch):
    w, batches = setup
    b = batches[0]
    n = b.num_voxels
    monkeypatch.setattr(sparse_unet, "masked_batch_norm", _bn64)
    model = _model(w).train()
    out = model(torch.from_numpy(b.feats).double(),
                geometry_to_device(b.geo, "cpu", 16), constant_input=True,
                return_prehead=True, step=0)[:n].detach()
    w64 = {k: v.double() for k, v in w.items()}
    ref = ref_ptv3.forward(
        {**w64, "final": torch.eye(16, dtype=torch.float64)[None]},
        REF_TINY, _ref_batch(b)[0], torch.ones((n, 3), dtype=torch.float64),
        model.last_orders, 0, SEED, train=True).detach()
    assert float((out - ref).abs().max()) <= 1e-10 * float(ref.abs().max())
    # padded rows stay exactly zero
    assert not model(torch.from_numpy(b.feats).double(),
                     geometry_to_device(b.geo, "cpu", 16), constant_input=True,
                     return_prehead=True)[n:].any()


def test_distill_steps_match_reference(setup, monkeypatch):
    """Two of the port's ``TrainStep`` (DropPath, shuffled orders, cosine
    loss, Adam) against the reference's, float64 on both sides."""
    w, batches = setup
    monkeypatch.setattr(sparse_unet, "masked_batch_norm", _bn64)
    model = _model(w)
    pcfg = Config(arch_3d="PTv3tiny", compute_dtype="float32", base_lr=1e-4,
                  power=0.9, loss_type="cosine")
    opt, sched = D.make_optimizer(pcfg, model, 100)
    step = D.make_train_step(pcfg, model, opt, sched, torch.device("cpu"))
    step.cdtype = torch.float64
    losses, orders = [], []
    for i, b in enumerate(batches):
        losses.append(float(step(b)))
        orders.append(model.last_orders)
        if i == 0:
            grad1 = {k: float(p.grad.norm())
                     for k, p in model.named_parameters()}
    w64 = {k: v.double() for k, v in w.items()}
    ref = ref_ptv3.train_steps(
        w64, [_ref_batch(b) for b in batches],
        {"arch_3d": "PTv3tiny", "base_lr": 1e-4, "power": 0.9}, 100, orders,
        SEED)
    # the head's output is fp32 in the port
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-7)
    gmed = statistics.median(ref["grad1"].values())
    for k, g in grad1.items():
        assert abs(g - ref["grad1"][k]) <= 1e-4 * max(ref["grad1"][k], gmed)
    cmed = statistics.median(ref["change"].values())
    for k, p in model.named_parameters():
        d = float((p.detach() - w64[k]).norm())
        assert abs(d - ref["change"][k]) <= 1e-4 * max(ref["change"][k],
                                                       cmed), k


def test_morton_codes_are_bit_interleaving():
    g = torch.randint(0, 1 << 12, (500, 3))
    x, y, z = g.unbind(1)
    want = sum((((x >> i) & 1) << (3 * i + 2)) | (((y >> i) & 1) << (3 * i + 1))
               | (((z >> i) & 1) << (3 * i)) for i in range(16))
    assert torch.equal(serialize.morton3(x, y, z), want)
    assert torch.equal(ref_ptv3.z_order(x, y, z, 12), want)


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_consecutive_hilbert_codes_are_face_neighbours(bits):
    n = 1 << bits
    g = torch.tensor(list(itertools.product(range(n), repeat=3)))
    x, y, z = g.unbind(1)
    for h in (serialize.hilbert3(x, y, z, torch.tensor(bits)),
              ref_ptv3.hilbert(x, y, z, bits)):
        assert sorted(h.tolist()) == list(range(n ** 3))
        walk = g[torch.argsort(h)]
        assert bool(((walk[1:] - walk[:-1]).abs().sum(1) == 1).all())


def test_orders_match_reference_and_trans_swaps_x_and_y():
    rng = np.random.default_rng(3)
    c = np.unique(np.concatenate(
        [np.c_[np.full(300, b), rng.integers(0, 200, (300, 3))]
         for b in range(3)]), axis=0)
    coords = torch.from_numpy(c)
    n = len(c)
    codes = serialize.level0_codes(torch.cat(
        [coords, torch.full((5, 4), 1 << 20)]).int(), n)[:, :n]
    depth = int(int(coords[:, 1:].max()) + 1).bit_length()
    ref = ref_ptv3.codes_of(coords, depth)
    for o in range(4):
        assert torch.equal(torch.argsort(codes[o]), torch.argsort(ref[o]))
    swapped = coords[:, [0, 2, 1, 3]]
    for o in (0, 2):
        assert torch.equal(ref_ptv3.codes_of(swapped, depth)[o + 1],
                           ref[o])
    # a coarser level's code is the same curve one bit shallower
    b, x, y, z = coords.unbind(1)
    h = serialize.hilbert3(x, y, z, depth)
    assert torch.equal(h >> 3, serialize.hilbert3(x >> 1, y >> 1, z >> 1,
                                                  depth - 1))


@pytest.mark.parametrize("counts", [[10, 40, 70], [16, 17, 32, 5],
                                    [1, 48, 33, 0], [3]])
def test_patch_layout_is_pointcepts(counts):
    patch, cap = 16, sum(counts) + 7
    pad, unpad, cu = serialize.patch_layout(torch.tensor(counts), patch,
                                            cap)
    offset = np.cumsum([c for c in counts if c]).tolist()
    r_pad, r_unpad, r_cu = ref_ptv3.padding_and_inverse(offset, patch,
                                                        "cpu")
    assert torch.equal(pad[:len(r_pad)], r_pad)
    assert torch.equal(unpad[:len(r_unpad)], r_unpad)
    assert torch.equal(cu[:len(r_cu)].long(), r_cu)
    assert bool((cu[len(r_cu):] == r_cu[-1]).all())
    assert len(cu) == cap // patch + len(counts) + 2


def test_drop_path_masks_equal_reference():
    c = torch.randint(0, 300, (4000, 4))
    c[:, 0] %= 8
    for seed, step, site in ((0, 0, 0), (2 ** 31 + 5, 7, 43), (123, 2, 9)):
        k = ptv3.drop_key(seed, step, site)
        assert k == ref_ptv3.drop_key(seed, step, site)
        keep = ptv3.keep_rows(c, k, 0.3)
        assert torch.equal(keep, ref_ptv3.keep_rows(c, k, 0.3))
        assert 0.65 < float(keep.float().mean()) < 0.75


def _level0(samples):
    b = assemble_distill_batch(samples, OUT, rng=np.random.default_rng(0))
    caps = merge_caps(b.geo.levels[0].coords[:b.num_voxels], None)
    return b, caps, torch.as_tensor(_pad_level(
        b.geo.levels[0].coords[:b.num_voxels], caps.cap0).coords)


def test_build_serializes_only_for_ptv3():
    """A MinkUNet build's outputs hold no serialization; a PTv3 build's
    equal the host plans' upload's."""
    b, caps, coords = _level0(_samples(0))
    cfg = Config(arch_3d="MinkUNet18A")
    geo, _ = G.card_build(cfg, "cpu", caps.fixed, batch_scenes=3)(
        coords, b.num_voxels)
    assert geo.serial == ()
    cfg = cfg.copy(arch_3d="PTv3tiny")
    geo, over = with_host_counts(*G.card_build(
        cfg, "cpu", caps.fixed, batch_scenes=3)(coords, b.num_voxels))
    assert not over and len(geo.serial) == 5
    host = geometry_to_device(b.geo, "cpu", 16).serial
    assert len(host) == 5
    for mine, theirs in zip(geo.serial, host):
        for u, v in zip(mine, theirs):
            assert torch.equal(u, v)
    # the search and the grid builds agree
    grid, _ = with_host_counts(*build_geometry_parts(
        coords, b.num_voxels, caps.fixed, stem_occupancy=True, n_scenes=3,
        serial=(16, 3)))
    for mine, theirs in zip(geo.serial, grid.serial):
        for u, v in zip(mine, theirs):
            assert torch.equal(u, v)


@pytest.mark.parametrize("arch", ["MinkUNet18A", "PTv3tiny"])
def test_host_upload_serializes_only_for_ptv3(setup, arch):
    """The route's host path (``CardGeometry.on_host``: overflow, device
    geometry off) serializes exactly where ``arch_3d`` reads it, for the
    scenes the batch holds."""
    b = setup[1][0]
    _, geo = G.CardGeometry(Config(arch_3d=arch),
                            torch.device("cpu")).on_host(b)
    if arch == "MinkUNet18A":
        assert geo.serial == ()
        return
    assert len(geo.serial) == 5
    n = b.num_voxels
    counts = serialize.scene_counts(geo.levels[0].coords, n, 3)
    want = serialize.patch_layout(counts, 16, geo.levels[0].cap)[2]
    assert torch.equal(geo.serial[0].cu_seqlens, want)


def test_model_refuses_geometry_without_serialization(setup):
    w, batches = setup
    b = batches[0]
    with pytest.raises(ValueError, match="serialization"):
        _model(w)(torch.from_numpy(b.feats).double(),
                  geometry_to_device(b.geo, "cpu"), constant_input=True)


def test_trainer_trains_ptv3_on_raw_batches(synth, tmp_path, head32,
                                            monkeypatch):
    """``DistillTrainer.train_step`` on a raw batch: one build, which
    serializes; the model reads that serialization; a finite loss."""
    made = []
    levels = serialize.serialize_levels

    def counted(*a, **k):
        made.append(1)
        return levels(*a, **k)
    monkeypatch.setattr(serialize, "serialize_levels", counted)
    import openscene_tpu_torch.sparse.geometry as HG
    import openscene_tpu_torch.sparse.geometry_device as GD
    monkeypatch.setattr(HG, "serialize_levels", counted)
    monkeypatch.setattr(GD, "serialize_levels", counted)
    tr = D.DistillTrainer(_trainer_cfg(
        synth, tmp_path, arch_3d="PTv3tiny", device_geometry="on",
        evaluate=False, voxel_size=0.1, compute_dtype="float32"),
        device="cpu")
    assert isinstance(tr.model, ptv3.PTv3)
    batch = next(tr._epoch_batches())
    loss = tr.train_step(batch)
    assert torch.isfinite(loss) and tr.global_step == 1
    assert len(made) == 1 and tr.model.last_orders is not None


def test_evaluator_distill_mode_on_ptv3(synth, tmp_path, head32):
    from openscene_tpu.data.synthetic import class_prototypes
    from openscene_tpu_torch.runtime import evaluate as E
    cfg = _trainer_cfg(synth, tmp_path, arch_3d="PTv3tiny", split="val",
                       feature_type="distill", voxel_size=0.1,
                       test_repeats=1, compute_dtype="float32",
                       device_geometry="off")
    model = E.load_model_for_eval(cfg, device="cpu")
    assert isinstance(model, ptv3.PTv3) and not model.training
    ev = E.ZeroShotEvaluator(cfg, model,
                             text_features=class_prototypes(20, DIM),
                             device="cpu")
    out = ev.run()
    assert 0.0 <= out["miou"] <= 1.0


@pytest.mark.parametrize("which", ["seg", "model_parallel"])
def test_trainers_refuse_ptv3(synth, tmp_path, which):
    from openscene_tpu_torch.runtime.train_seg import SegTrainer
    with pytest.raises(ValueError, match="PTv3tiny"):
        if which == "seg":
            SegTrainer(_trainer_cfg(synth, tmp_path, arch_3d="PTv3tiny"),
                       device="cpu")
        else:
            D.DistillTrainer(_trainer_cfg(synth, tmp_path,
                                          arch_3d="PTv3tiny",
                                          model_parallel=2), device="cpu")

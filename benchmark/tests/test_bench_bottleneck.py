"""The bottleneck cell's pieces on the CPU: the port's MinkUNet101 at its
published widths against ``reference/bottleneck.py`` (float32, a tiny
scene: the training forward and two distill train steps); the bottleneck
counts against a brute count over the port model's weights and the
scene's pairs; the readers of ``unet.bn`` and ``unet.conv1x1`` on a
hand-made trace."""

import threading

import numpy as np
import pytest
import torch

from benchmark import counts_bottleneck, run
from benchmark.devtrace import DeviceTrace
from benchmark.reference import bottleneck
from benchmark.reference import geometry as ref_geometry
from benchmark.spans import Spans
from benchmark.tests.test_bench_counts import tiny_coords

ARCH = "MinkUNet101"
DIM = 768
CFG = {"arch_3d": ARCH, "base_lr": 1e-4, "power": 0.9}


def _samples(seed, n_scenes=2):
    """Scenes of random voxels in a 40^3 box (level 4 keeps a few rows a
    scene), constant features, 80% with a random 768-d target."""
    from openscene_tpu_torch.data.loaders import SceneSample
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_scenes):
        c = np.unique(rng.integers(0, 40, (900, 3)), axis=0).astype(np.int32)
        fm = rng.random(len(c)) < 0.8
        out.append(SceneSample(
            c, np.ones((len(c), 3), np.float32),
            rng.integers(0, 20, len(c)), None,
            rng.standard_normal((int(fm.sum()), DIM)).astype(np.float16), fm))
    return out


def _model(w, dtype=torch.float32):
    from openscene_tpu_torch.models.sparse_unet import MinkUNet
    model = MinkUNet(3, DIM, ARCH)
    model.load_state_dict({k: w[k] for k in model.state_dict()})
    return model.to(dtype)


@pytest.fixture(scope="module")
def setup():
    """The reference's weights (3 -> 768) and two batches."""
    from openscene_tpu_torch.data.batch import assemble_distill_batch
    w = bottleneck.make_weights(ARCH, 3, DIM, 11, "cpu")
    batches = [assemble_distill_batch(_samples(s), DIM,
                                      rng=np.random.default_rng(s))
               for s in range(2)]
    return w, batches


def _ref_batch(b):
    n = b.num_voxels
    return (torch.from_numpy(b.geo.levels[0].coords[:n]).long(),
            torch.from_numpy(b.feat_3d[:n]), torch.from_numpy(b.mask[:n]))


def test_param_shapes_are_the_port_models():
    from openscene_tpu_torch.models.sparse_unet import MinkUNet
    model = MinkUNet(3, DIM, ARCH)
    shapes = bottleneck.param_shapes(ARCH, 3, DIM)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
        == shapes
    n = sum(int(np.prod(s)) for k, s in shapes.items()
            if not k.endswith((".mean", ".var")))
    assert n == sum(p.numel() for p in model.parameters()) == 71_096_800


def test_forward_matches_reference(setup):
    """The training forward in float32, under autograd as a step runs it
    (the 1x1 convs through ``Conv1x1Fn``): within 1e-5 of the output's
    scale."""
    from openscene_tpu_torch.sparse.geometry import geometry_to_device
    w, batches = setup
    b = batches[0]
    n = b.num_voxels
    model = _model(w).train()
    out = model(torch.from_numpy(b.feats), geometry_to_device(b.geo, "cpu"),
                constant_input=True)[:n].detach()
    coords = _ref_batch(b)[0]
    ref = bottleneck.forward(w, ref_geometry.build(coords),
                             torch.ones((n, 3)), ARCH, train=True).detach()
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-5 * scale


def _bn64(x, mask, num, gamma, beta, running_mean, running_var, *, train,
          momentum=0.1, eps=1e-5):
    """The masked BatchNorm in float64 (the port's computes in fp32 for
    every input), as ``tests/test_torch_resnet.py`` runs its float64
    model."""
    x, mask = x.double(), mask.double()
    n = float(max(int(num), 1))
    mean = (x * mask).sum(0) / n
    var = (((x - mean) * mask) ** 2).sum(0) / n
    out = ((x - mean) * torch.rsqrt(var + eps) * gamma + beta) * mask
    return out, running_mean, running_var


def test_distill_steps_match_reference(setup, monkeypatch):
    """Two steps of the port's ``TrainStep`` (cosine loss, Adam) against
    the reference's, both in float64: in float32 Adam's second step moves
    some BatchNorm leaves of the reference itself by up to 10% between
    float32 and float64 on this scene, so neither side's rounding may
    enter a 1% comparison."""
    from openscene_tpu_torch.config import Config
    from openscene_tpu_torch.models import sparse_unet
    from openscene_tpu_torch.runtime.distill import (make_optimizer,
                                                     make_train_step)
    w, batches = setup
    w64 = {k: v.double() for k, v in w.items()}
    model = _model(w, torch.float64)
    pcfg = Config(arch_3d=ARCH, compute_dtype="float32", base_lr=1e-4,
                  power=0.9, loss_type="cosine")
    opt, sched = make_optimizer(pcfg, model, 100)
    step = make_train_step(pcfg, model, opt, sched, torch.device("cpu"))
    step.cdtype = torch.float64
    monkeypatch.setattr(sparse_unet, "masked_batch_norm", _bn64)
    losses = [float(step(b)) for b in batches]
    ref = bottleneck.train_steps(
        w64, [(c, t.double(), m) for c, t, m in map(_ref_batch, batches)],
        CFG, 100)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    # as the 18A seg test: 1% of each leaf's change after two steps
    for k, p in model.named_parameters():
        d = float((p.detach() - w64[k]).norm())
        assert abs(d - ref["change"][k]) <= 1e-2 * max(ref["change"][k],
                                                       1e-4), k


def _level(name: str) -> int:
    """The level of a block's layers; of a down/up conv, its child level."""
    top = name.split(".")[0]
    if top.startswith("block"):
        i = int(top[5:])
        return i if i <= 4 else 8 - i
    if top.startswith("convtr") or top.startswith("bntr"):
        return 7 - int(top[-1])
    if top in ("conv0", "bn0", "final"):
        return 0
    return int(top[-1]) - (1 if top.startswith("conv") else 0)


def test_counts_match_a_brute_count_over_the_weights():
    from openscene_tpu_torch.models.sparse_unet import MinkUNet, \
        MaskedBatchNorm
    from benchmark.entries.seg_step import batch_counts
    c = tiny_coords()
    geo = ref_geometry.build(torch.from_numpy(c))
    lc = batch_counts(c, "cpu")
    model = MinkUNet(3, DIM, ARCH)
    arch = bottleneck.ARCHS[ARCH]
    fwd, stem = 0.0, 0.0
    convs, gemms = [], []
    for name, p in model.named_parameters():
        if p.dim() != 3:
            continue
        k, cin, cout = p.shape
        lvl = _level(name)
        if k == 125:
            stem = 2.0 * geo.stem.count() * cin * cout
            fwd += stem
        elif k == 27:
            fwd += 2.0 * geo.self3[lvl].count() * cin * cout
            convs.append(("stencil", lvl, cin, cout))
        elif k == 8:
            fwd += 2.0 * geo.num[lvl] * cin * cout
            convs.append(("up" if "tr" in name else "down", lvl, cin, cout))
        else:
            fwd += 2.0 * geo.num[lvl] * cin * cout
            if name != "final":
                gemms.append((lvl, cin, cout))
    norms = sorted((_level(n), m.gamma.numel())
                   for n, m in model.named_modules()
                   if isinstance(m, MaskedBatchNorm))
    assert sorted(counts_bottleneck.wrapper_convs(arch)) == sorted(convs)
    got = counts_bottleneck.gemms(arch)
    assert got[0] == (0, 125, 32, False)
    assert sorted(g[:3] for g in got[1:]) == sorted(gemms)
    assert sorted(counts_bottleneck.batch_norms(arch)) == norms
    facts = counts_bottleneck.step_facts(arch, lc, 3, DIM)
    assert facts["flops"] == pytest.approx(3 * fwd - stem, rel=1e-12)
    bn = sum(5 * 2 * geo.num[l] * ch for l, ch in norms) / 3.35e12 * 1e3
    assert facts["bn_bound_ms"] == pytest.approx(bn, rel=1e-12)
    assert facts["conv1x1_bound_ms"] > 0 and facts["conv_bound_ms"] > 0


# the readers, on a hand-made trace: the window [H0, H1] on the host maps
# onto [D0, D1] us on the trace
MAIN, AUTOGRAD = 11, 22
H0, H1, D0, D1 = 5.0, 5.001, 1000.0, 2000.0


def host(us):
    return H0 + us * 1e-6


def _trace():
    def launch(ts, corr, tid):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": D0 + ts, "dur": 2, "tid": tid,
                "args": {"correlation": corr}}

    def kernel(ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": D0 + ts,
                "dur": dur, "args": {"correlation": corr}}

    return DeviceTrace([
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": D0, "dur": D1 - D0, "tid": MAIN},
        launch(110, 1, MAIN), kernel(120, 30, 1),         # forward BN
        launch(210, 2, MAIN), kernel(220, 10, 2),         # forward 1x1
        launch(610, 3, AUTOGRAD), kernel(620, 50, 3),     # backward BN
        launch(710, 4, AUTOGRAD), kernel(720, 20, 4),     # backward 1x1
        launch(800, 5, MAIN), kernel(810, 100, 5)])       # in neither


@pytest.mark.parametrize("metric,value", [
    ("bn_ms.train_step", 0.080), ("conv1x1_ms.train_step", 0.030),
    ("bn_roofline.train_step", 100 * 0.004 / 0.080),
    ("conv1x1_roofline.train_step", 100 * 0.006 / 0.030)])
def test_layer_readers_read_spans_of_any_thread(metric, value, monkeypatch):
    """A value where the port's spans of the name are in the window (the
    backward's on autograd's thread), None where the program has none."""
    from openscene_tpu_torch.utils import profiling
    main = threading.main_thread().ident
    recs = [("unet.bn", main, host(100), host(200)),
            ("unet.conv1x1", main, host(200), host(300)),
            ("unet.bn", 77, host(600), host(700)),
            ("unet.conv1x1", 77, host(700), host(750))]
    spans = Spans()
    spans.record("window", H0, H1)
    units = [{"items": 1, "bn_bound_ms": 0.004, "conv1x1_bound_ms": 0.006}]
    readings = run.Readings(spans, units, (H0, H1), _trace(),
                            {"platform": "gpu"})
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    assert run.metric_reader(metric)(readings) == pytest.approx(value)
    monkeypatch.setattr(profiling, "records", lambda: [])
    assert run.metric_reader(metric)(readings) is None
    monkeypatch.delattr(profiling, "records")
    assert run.metric_reader(metric)(readings) is None

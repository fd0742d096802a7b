"""The port's spans (``utils/profiling.span``) on the CPU.

* Off (no profiler recording): ``span`` is the one shared null context and
  records nothing.
* Under ``torch.profiler.profile()``, a one-room ensemble
  ``ZeroShotEvaluator.run()`` with device geometry and two loader threads
  records every eval span: the loader's ``read`` and ``scatter`` from the prefetch threads,
  the queue's wait, the assembly, the geometry's launches and wait, the
  step, the host rows and the mIoU from the main thread.
* ``TrainStep.run`` (on a linear model's loss) records
  ``train.forward``, ``train.backward`` and ``train.optimizer`` in that
  order, one after the other.
* A main-thread span is a ``record_function`` range of its name in the
  Chrome trace ``trace`` writes; a block that raises still ends its span.
"""

import json
import os
import threading

import pytest
import torch

from openscene_tpu_torch.config import Config
from openscene_tpu_torch.data import prefetch
from openscene_tpu_torch.data.synthetic import (build_synthetic_dataset,
                                                class_prototypes)
from openscene_tpu_torch.models import MinkUNet
from openscene_tpu_torch.runtime import distill as D
from openscene_tpu_torch.runtime.evaluate import ZeroShotEvaluator
from openscene_tpu_torch.utils import profiling
from tests.test_torch_unet import _one_thread  # noqa: F401

ARCH = "MinkUNet14A"
DIM = 32
EVAL_SPANS = {"prefetch.wait", "loader.read", "loader.scatter",
              "eval.assemble", "geometry.build", "geometry.wait",
              "eval.step", "eval.host_rows", "eval.miou"}


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_torch_profiling")
    return build_synthetic_dataset(str(root), n_train=0, n_val=1, dim=DIM,
                                   density=150.0)


def test_span_off_records_nothing():
    profiling.clear()
    a, b = profiling.span("eval.step"), profiling.span("train.forward")
    assert a is b
    with a:
        torch.ones(4).sum()
    assert profiling.records() == []


def test_eval_spans_under_profiler(synth, monkeypatch):
    d3, dfeat = synth
    cfg = Config(data_root=d3, data_root_2d_fused_feature=dfeat,
                 feature_2d_extractor="openseg", voxel_size=0.05,
                 split="val", feature_type="ensemble", test_repeats=1,
                 test_workers=2, manual_seed=0, arch_3d=ARCH,
                 device_geometry="on")
    model = MinkUNet(3, DIM, ARCH)
    ev = ZeroShotEvaluator(cfg, model, text_features=class_prototypes(20,
                                                                      DIM),
                           device="cpu")
    workers = set()
    worker = prefetch.Prefetcher._worker

    def counted(self):
        workers.add(threading.get_ident())
        worker(self)

    monkeypatch.setattr(prefetch.Prefetcher, "_worker", counted)
    profiling.clear()
    with _profile():
        ev.run()
    recs = profiling.records()
    main = threading.main_thread().ident
    by_name = {}
    for r in recs:
        assert r.t0 <= r.t1
        by_name.setdefault(r.name, []).append(r)
    assert set(by_name) == EVAL_SPANS
    assert len(workers) == 2
    for name, rs in by_name.items():
        threads = {r.thread for r in rs}
        if name.startswith("loader."):
            assert threads <= workers, name
        else:
            assert threads == {main}, name
    assert len(by_name["loader.scatter"]) == 2     # full cloud, then rows
    for name in EVAL_SPANS - {"loader.scatter"}:
        assert len(by_name[name]) == 1, name
    profiling.clear()
    assert profiling.records() == []


class _LinearStep(D.TrainStep):
    def loss_on(self, geo, x, y):
        return ((self.model(x) - y) ** 2).mean()


def test_train_step_spans_in_order():
    model = torch.nn.Linear(4, 2)
    w0 = model.weight.detach().clone()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = _LinearStep(Config(), model, opt, lambda it: 0.1, "cpu")
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(8, 4, generator=g), torch.randn(8, 2, generator=g)
    profiling.clear()
    with _profile():
        loss = step.run(None, x, y)
    assert torch.isfinite(loss) and not torch.equal(model.weight, w0)
    recs = [r for r in profiling.records() if r.name.startswith("train.")]
    assert [r.name for r in recs] == ["train.forward", "train.backward",
                                      "train.optimizer"]
    assert {r.thread for r in recs} == {threading.main_thread().ident}
    for a, b in zip(recs, recs[1:]):
        assert a.t0 <= a.t1 <= b.t0 <= b.t1


def test_span_is_a_range_in_the_chrome_trace(tmp_path):
    profiling.clear()
    with profiling.trace(str(tmp_path)):
        with profiling.span("test.region"):
            torch.ones((32, 32)).matmul(torch.ones((32, 32))).sum()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("name") == "test.region"
              and e.get("cat") == "user_annotation"]
    assert len(ranges) == 1 and ranges[0]["dur"] >= 0
    (rec,) = profiling.records()
    assert rec.name == "test.region" and rec.t0 <= rec.t1


def test_span_ends_when_its_block_raises():
    profiling.clear()
    with _profile() as prof:
        with pytest.raises(ValueError):
            with profiling.span("test.raises"):
                raise ValueError("inside the span")
    assert [r.name for r in profiling.records()] == ["test.raises"]
    assert any(e.key == "test.raises" for e in prof.key_averages())

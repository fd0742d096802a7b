"""``benchmark/program_spans.py`` on a hand-made trace: the window's two
ends map host times onto the trace's clock (the drift between them
included), the benchmark's ranges pair with its spans as anchors and a
lagging window start among them is dropped, a launch on another thread
inside a ``train.backward`` span counts its kernel, and an idle gap that a
span covers is split from one that no span covers.  The readers read
their spans, and stay silent for a program without the span API."""

import pytest

from benchmark import program_spans, run
from benchmark.devtrace import DeviceTrace
from benchmark.spans import Spans

MAIN, AUTOGRAD = 11, 22
H0, H1 = 5.0, 5.001                  # the window on the host, s
D0, D1 = 1000.0, 2001.0              # the window on the trace, us
SCALE = (D1 - D0) / 1000.0           # trace us per host us
ENDS = [(H0, D0), (H1, D1)]          # the window's two ends as anchors


def host(us: float) -> float:
    """The host time ``us`` microseconds into the window."""
    return H0 + us * 1e-6


def trace_at(us: float) -> float:
    return D0 + us * SCALE


RECORDS = [("train.forward", MAIN, host(100), host(300)),
           ("train.backward", MAIN, host(300), host(600)),
           ("train.optimizer", MAIN, host(600), host(700)),
           ("loader.read", 99, host(50), host(950)),        # another thread
           ("train.forward", MAIN, host(-50), host(-10))]   # before the window


def _kernel(ts, dur, corr, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(ts, corr, tid, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 2, "tid": tid, "args": {"correlation": corr}}


def _trace() -> DeviceTrace:
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
               "ts": D0, "dur": D1 - D0, "tid": MAIN},
              # forward: launched on the main thread
              _launch(trace_at(150), 1, MAIN),
              _kernel(trace_at(160), 100, 1),
              # backward: launched from autograd's thread inside the span
              _launch(trace_at(400), 2, AUTOGRAD),
              _kernel(trace_at(420), 80, 2),
              # a copy issued in the optimizer span
              _launch(trace_at(650), 3, MAIN, "cudaMemcpyAsync"),
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
               "ts": trace_at(660), "dur": 10, "args": {"correlation": 3}},
              # outside every span: counts for no span
              _launch(trace_at(850), 4, MAIN),
              _kernel(trace_at(900), D1 - trace_at(900), 4)]
    return DeviceTrace(events)


def test_window_anchors_map_both_ends():
    p = program_spans.ProgramSpans(RECORDS, (H0, H1), ENDS, main=MAIN)
    assert p.to_trace(H0) == pytest.approx(D0)
    assert p.to_trace(H1) == pytest.approx(D1)
    assert p.to_trace(host(500)) == pytest.approx(D0 + 500 * SCALE)
    assert p.drift_us == pytest.approx(1.0)
    # the span that ended before the window is left out
    assert p.count("train.forward") == 1
    assert p.host_ms("train.forward") == pytest.approx(0.2)
    assert p.count("loader.read") == 0
    assert p.count("loader.read", main=False) == 1


def _range(name, a, b, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": "bench." + name,
            "ts": a, "dur": b - a, "tid": tid}


def test_anchors_pair_ranges_and_drop_a_lagging_start():
    spans = Spans()
    spans.record("window", H0, H1)
    events = [_range("window", D0 + 500, D1)]    # the first range lags
    for k in range(10):
        a, b = 50 + 90 * k, 100 + 90 * k
        spans.record("step", host(a), host(b))
        events.append(_range("step", trace_at(a), trace_at(b)))
        spans.record("loader", host(a), host(b))   # its ranges never reach
    anchors = program_spans.clock_anchors(spans, DeviceTrace(events))
    assert len(anchors) == 2 + 20
    assert (host(50), pytest.approx(trace_at(50))) in anchors
    p = program_spans.ProgramSpans([], (H0, H1), anchors)
    assert p.to_trace(H0) == pytest.approx(D0, abs=1e-3)
    assert p.to_trace(host(700)) == pytest.approx(trace_at(700), abs=1e-3)
    assert p.drift_us == pytest.approx(1.0, abs=1e-3)


def test_launches_on_any_thread_count_by_interval():
    p = program_spans.ProgramSpans(RECORDS, (H0, H1), ENDS, main=MAIN)
    t = _trace()
    assert p.device_us(t, "train.forward") == pytest.approx(100)
    assert p.device_us(t, "train.backward") == pytest.approx(80)
    assert p.device_us(t, "train.optimizer") == pytest.approx(10)
    assert p.launches(t, "train.backward") == 1
    assert p.launches(t, "train.optimizer") == 0     # a copy, no launch
    assert p.launches(t, "loader.read") == 0          # not the main thread


def test_idle_split_by_innermost_span():
    p = program_spans.ProgramSpans(RECORDS, (H0, H1), ENDS, main=MAIN)
    t = _trace()
    split = p.idle_split(t)
    busy = 100 + 80 + 10 + (D1 - trace_at(900))
    assert sum(split.values()) == pytest.approx(t.window_us() - busy)
    # each span's idle time is its length less its kernel's or copy's
    assert split["train.forward"] == pytest.approx(200 * SCALE - 100)
    assert split["train.backward"] == pytest.approx(300 * SCALE - 80)
    assert split["train.optimizer"] == pytest.approx(100 * SCALE - 10)
    # [0, 100] and [700, 900] us: the main thread in no span (the loader's
    # thread is not the main one)
    assert split[None] == pytest.approx(300 * SCALE)
    assert set(split) == {"train.forward", "train.backward",
                          "train.optimizer", None}
    assert p.idle_unattributed(t) == pytest.approx(
        100 * split[None] / sum(split.values()))


def test_nested_spans_split_by_the_inner_one():
    recs = [("eval.run", MAIN, host(0), host(1000)),
            ("eval.step", MAIN, host(200), host(400))]
    p = program_spans.ProgramSpans(recs, (H0, H1), ENDS, main=MAIN)
    t = DeviceTrace([{"ph": "X", "cat": "user_annotation",
                      "name": "bench.window", "ts": D0, "dur": D1 - D0}])
    split = p.idle_split(t)
    assert split["eval.step"] == pytest.approx(200 * SCALE)
    assert split["eval.run"] == pytest.approx(800 * SCALE)
    assert split.get(None, 0.0) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("metric", [
    "geometry_launch_ms.train_step", "geometry_launches.train_step",
    "forward_ms.train_step", "backward_ms.train_step",
    "optimizer_ms.train_step", "idle_unattributed.train_step",
    "loader_wait_ms.eval", "loader_read_ms.eval", "loader_scatter_ms.eval",
    "assemble_ms.eval", "idle_unattributed.eval"])
def test_readers_read_the_spans_and_fall_silent_without_them(metric,
                                                              monkeypatch):
    """Each reader finds its spans in this process's records (on its main
    thread), and returns None where the program has no ``records``."""
    import threading
    from openscene_tpu_torch.utils import profiling
    main = threading.main_thread().ident
    recs = [(n, main if t == MAIN else t, a, b) for n, t, a, b in RECORDS]
    recs += [("geometry.build", main, host(110), host(200)),
             ("prefetch.wait", main, host(5), host(45)),
             ("eval.assemble", main, host(700), host(800)),
             ("loader.scatter", 99, host(960), host(990))]
    spans = Spans()
    spans.record("window", H0, H1)
    readings = run.Readings(spans, [{"items": 1}], (H0, H1), _trace(),
                            {"platform": "gpu"})
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    assert run.metric_reader(metric)(readings) is not None
    monkeypatch.delattr(profiling, "records")
    assert run.metric_reader(metric)(readings) is None

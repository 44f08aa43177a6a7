"""``benchmark/spans.py`` on synthetic traces and records: device work joined
to its launch by correlation id and given to the innermost span, idle
time to the span open when a gap opens (or ``outside``), a device
operation with no launch, the spans outside every pass, the host record
of the port's tracer, and the per-pass readers."""

import pytest

from benchmark import spans, tracing
from pbrt_v3_iile_tpu_torch.utils import stats


def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def EVENTS():
    return [
        X("user_annotation", tracing.WINDOW, 0.0, 100.0),
        X("user_annotation", "render/pass", 1.0, 79.0),
        X("user_annotation", "path/bounce[0]", 5.0, 55.0),
        X("user_annotation", "path/nee", 10.0, 19.0),
        X("user_annotation", "samples/draw", 12.0, 2.0),
        X("user_annotation", "aten::mul", 12.5, 0.5),      # not a program span
        X("cuda_runtime", "cudaLaunchKernel", 13.0, 0.2, corr=1),
        X("cuda_runtime", "cudaLaunchKernel", 20.0, 0.2, corr=2),
        X("cuda_driver", "cuLaunchKernel", 50.0, 0.2, corr=3),
        X("cuda_runtime", "cudaMemcpyAsync", 70.0, 0.2, corr=6),
        X("cuda_runtime", "cudaLaunchKernel", 90.0, 0.2, corr=4),
        X("kernel", "k_draw", 15.0, 5.0, corr=1),
        X("kernel", "k_nee", 22.0, 8.0, corr=2),
        X("kernel", "k_bounce", 55.0, 10.0, corr=3),
        X("gpu_memcpy", "Memcpy DtoH", 70.0, 2.0, corr=6),
        X("kernel", "k_out", 91.0, 4.0, corr=4),
        X("kernel", "k_orphan", 96.0, 2.0, corr=5),         # no launch event
    ]


def test_by_span_joins_launches_and_gives_idle_time():
    r = spans.by_span(EVENTS())
    assert set(r) == {"render/pass", "path/bounce[0]", "path/nee", "samples/draw",
                      spans.OUTSIDE, spans.UNLAUNCHED}
    ap = pytest.approx
    # kernels and device time: the innermost span open at the launch
    assert (r["samples/draw"]["kernels"], r["samples/draw"]["device_s"]) == (1, ap(5e-6))
    assert (r["path/nee"]["kernels"], r["path/nee"]["device_s"]) == (1, ap(8e-6))
    assert (r["path/bounce[0]"]["kernels"], r["path/bounce[0]"]["device_s"]) == (1, ap(10e-6))
    # a copy counts device time and no kernel
    assert (r["render/pass"]["kernels"], r["render/pass"]["device_s"]) == (0, ap(2e-6))
    assert (r[spans.OUTSIDE]["kernels"], r[spans.OUTSIDE]["device_s"]) == (1, ap(4e-6))
    assert (r[spans.UNLAUNCHED]["kernels"], r[spans.UNLAUNCHED]["device_s"]) == (1, ap(2e-6))
    # idle: gaps 0-15 (outside: no span open at 0), 20-22 (path/nee),
    # 30-55 (path/bounce[0]: path/nee closed at 29), 65-70 and 72-91
    # (render/pass), 95-96 and 98-100 (outside)
    assert r[spans.OUTSIDE]["idle_s"] == ap((15 + 1 + 2) * 1e-6)
    assert r["path/nee"]["idle_s"] == ap(2e-6)
    assert r["path/bounce[0]"]["idle_s"] == ap(25e-6)
    assert r["render/pass"]["idle_s"] == ap((5 + 19) * 1e-6)
    assert r["samples/draw"]["idle_s"] == 0.0
    total_idle = sum(v["idle_s"] for v in r.values())
    busy = tracing.summarize(EVENTS())["busy_s"]
    assert total_idle + busy == ap(100e-6)
    # host time and self time of the spans in the trace
    assert (r["render/pass"]["calls"], r["render/pass"]["host_s"]) == (1, ap(79e-6))
    assert r["render/pass"]["self_s"] == ap(24e-6)
    assert r["path/bounce[0]"]["self_s"] == ap(36e-6)
    assert r["path/nee"]["self_s"] == ap(17e-6)
    assert r["samples/draw"]["self_s"] == ap(2e-6)
    assert r[spans.OUTSIDE]["calls"] == 0
    assert r["render/pass"]["ops"] == [["Memcpy DtoH", ap(2e-6)]]
    assert r["samples/draw"]["ops"] == [["k_draw", ap(5e-6)]]


def test_by_span_needs_the_window():
    with pytest.raises(ValueError):
        spans.by_span(EVENTS()[1:])


def test_trace_record_share_and_spans_outside_the_pass():
    ev = EVENTS() + [X("user_annotation", "path/flush", 85.0, 2.0)]
    t = spans.trace_record(ev, passes=1)
    assert t["outside_pass"] == 1             # path/flush lies after render/pass
    assert t["named_device_share"] == pytest.approx(25 / 31)
    assert spans.outside_outer(EVENTS()) == 0


@pytest.fixture
def tracer(monkeypatch):
    clock = iter(range(0, 10_000, 10))
    monkeypatch.setattr(stats.time, "perf_counter_ns", lambda: next(clock))
    stats.reset()
    stats.enable(True)
    yield
    stats.enable(False)
    stats.reset()


def test_host_record_syncs_inside_the_passes(tracer):
    for _ in range(2):
        with stats.stage("render/pass"):
            with stats.stage("path/intersect"):
                with stats.sync_point("k1_overflow"):
                    pass
            with stats.sync_point("luminance_weights"):
                pass
    with stats.sync_point("rays_total"):
        pass
    h = spans.host_record(passes=2, wall_s=1.0)
    assert h["counters"] == {"syncs/k1_overflow": 2, "syncs/luminance_weights": 2,
                             "syncs/rays_total": 1}
    assert h["sync_in_pass_s"] == pytest.approx(4 * 10e-9)
    rec = dict(spans_host=h)
    assert spans.READERS["host_syncs_per_pass.path"](rec) == 2.5
    assert spans.READERS["sync_wait_ms.path"](rec) == pytest.approx(1e3 * 50e-9 / 2)
    # render/pass: 70 ns each, 20 of them in its syncs
    assert spans.READERS["enqueue_ms.path"](rec) == pytest.approx(1e3 * 50e-9)
    rec["spans_trace"] = spans.trace_record(EVENTS(), passes=2)
    lines = spans.table(rec)
    assert lines[0].split()[1:] == ["name", "calls", "host_ms", "self_ms", "kernels",
                                    "device_ms", "idle_ms"]
    row = {ln.split()[1]: ln.split()[2:] for ln in lines[1:]}
    assert row["render/pass"][:3] == ["1.00", "0.000", "0.000"]     # 70 ns, 10 ns self
    assert row["path/bounce[0]"][3:5] == ["0.5", "0.005"]           # 1 kernel, 10 us


def test_readers_from_the_trace():
    rec = dict(spans_trace=spans.trace_record(
        EVENTS() + [X("user_annotation", "path/bsdf", 40.0, 2.0),
                    X("cuda_runtime", "cudaLaunchKernel", 41.0, 0.2, corr=7),
                    X("kernel", "k_lobe", 81.0, 3.0, corr=7)], passes=2))
    assert spans.READERS["bsdf_device_ms.path"](rec) == pytest.approx(1e3 * 3e-6 / 2)
    assert spans.READERS["sampler_kernels_per_pass.path"](rec) == 0.5
    assert rec["spans_trace"]["spans"]["path/bsdf"]["ops"] == [["k_lobe", pytest.approx(3e-6)]]


@pytest.mark.parametrize("rec", [{}, {"spans_host": None, "spans_trace": None},
                                 {"spans_host": {}, "spans_trace": {"spans": {}}},
                                 {"trace": {"busy_s": 1.0}, "frames": 3}])
@pytest.mark.parametrize("name", sorted(spans.READERS))
def test_readers_none_without_spans(rec, name):
    assert spans.READERS[name](rec) is None


def test_by_span_keeps_the_top_ops_of_a_span():
    assert spans.TOP_OPS == 3
    ev = [X("user_annotation", tracing.WINDOW, 0.0, 100.0),
          X("user_annotation", "path/bsdf", 1.0, 50.0)]
    for i, dur in enumerate((1.0, 4.0, 2.0, 3.0, 2.5)):
        ev += [X("cuda_runtime", "cudaLaunchKernel", 2.0 + i, 0.1, corr=i),
               X("kernel", f"k{i % 4}", 10.0 + 10 * i, dur, corr=i)]
    r = spans.by_span(ev)["path/bsdf"]
    assert r["kernels"] == 5 and r["device_s"] == pytest.approx(12.5e-6)
    assert [n for n, _ in r["ops"]] == ["k1", "k0", "k3"]   # k0 twice: 1 + 2.5
    assert r["ops"][1][1] == pytest.approx(3.5e-6)

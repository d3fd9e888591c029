"""The yardstick's arithmetic, the import guard and the result line."""

import json
import math

from phbench import harness, loadgen, roofline


def test_k3_bound_at_1m_is_the_kernel_tables():
    b = roofline.sweep_bound(1_000_000, 8, 256, 1_000_000 * 8 * 32)
    assert b["bound_by"] == "operations"
    assert round(b["bound_ms"], 1) == 1034.9


def test_corpus_query_bound_is_set_by_bytes():
    b = roofline.corpus_query_bound(1_000_000, 8, 256)
    assert b["bound_by"] == "bytes"
    assert math.isclose(b["bound_ms"], 33e6 / 3.35e12 * 1e3)


def test_extract_bound_counts_later_rows():
    b = roofline.extract_bound(10, [0, 8], 8, 256)
    later = 9 + 1
    assert math.isclose(b["bound_ms"],
                        max(later * 8 * 512 / roofline.INT8_OPS,
                            (2 * 8 * 32 + 10 * 32 + later / 8)
                            / roofline.HBM_BYTES) * 1e3)


def test_import_guard_compares_whole_top_level_names():
    assert harness.forbidden_loaded({"rupphash_tpu_torch": 1,
                                     "rupphash_tpu_torch.serve": 1,
                                     "jaxtyping": 1}) == []
    assert harness.forbidden_loaded({"rupphash_tpu.cli": 1}) == [
        "rupphash_tpu"]
    assert harness.forbidden_loaded({"jax": 1, "jaxlib.xla": 1}) == [
        "jax", "jaxlib"]


def test_result_line_schema():
    checks = harness.Checks()
    checks.add("groups_off", 0, 0)
    line = harness.result_line(
        correct=checks.correct, attempted=3, failed=0,
        metrics={"files_per_s": {"value": 1.5, "unit": "files/s"}},
        device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                "count": 1, "memory_peak_bytes": 1},
        checks=checks.as_dict(), breakdown={"device_ops": [],
                                            "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["correct"] is True
    checks.add("edge_count_gap", 1, 0)
    assert not checks.correct


def test_percentiles_and_spread():
    xs = list(range(1, 101))
    assert harness.percentile(xs, 50) == 50
    assert harness.percentile(xs, 99) == 99
    assert harness.percentile([1.0, float("inf")], 99) == float("inf")
    assert math.isclose(harness.quartile_spread([1, 2, 3, 4, 5]),
                        (4.5 - 1.5) / 3)


def test_open_schedule_is_the_same_gaps_for_every_seed():
    rate, seconds = 50, 10
    n = rate * seconds
    quantiles = {round(-math.log(1 - (k + 0.5) / n) / rate, 12)
                 for k in range(n)}
    a = loadgen.schedule_open(rate, seconds, 1)
    b = loadgen.schedule_open(rate, seconds, 2)
    assert a != b and 480 <= len(a) <= 500 and 480 <= len(b) <= 500
    for due in (a, b):
        gaps = [round(y - x, 12) for x, y in zip([0.0] + due, due)]
        assert all(g in quantiles or any(abs(g - q) < 1e-9
                                         for q in quantiles) for g in gaps)


def test_idle_gaps_go_to_the_innermost_span():
    from phbench import tracing

    tl = tracing.Timeline.__new__(tracing.Timeline)
    tl.window = (0, 100)
    tl.busy = [[10, 20], [60, 70]]
    # outer span 0-100 (long), inner span 30-50 (short)
    tl._ranges = {"phbench.outer": [(0, 100)], "phbench.inner": [(30, 50)]}
    gaps = dict(tl.idle_gaps())
    assert gaps == {"phbench.outer": 60e-9, "phbench.inner": 20e-9}
    tl._ranges = {"phbench.inner": [(30, 50), (65, 90)]}
    gaps = dict(tl.idle_gaps())
    assert gaps == {"phbench.inner": 40e-9, "outside spans": 40e-9}
    # the program's spans (record_function ranges, user annotations on
    # the host) nest inside the benchmark's wrapper and take its gaps
    tl = tracing.Timeline(_Profile([
        _Event(tracing.WINDOW, 0, 100, annotation=True),
        _Event("phbench.group_files", 0, 100, annotation=True, corr=1),
        _Event("group", 5, 90, annotation=True, corr=2),
        _Event("group.resident_rows", 30, 20, annotation=True, corr=3),
        _Event("aten::copy_", 12, 2, corr=4),
        _Event("cudaLaunchKernel", 13, 1, corr=5, linked=4),
        _Event("kernel", 10, 10, device=True, linked=4),
        _Event("kernel", 60, 10, device=True, linked=4),
        _Event("group", 5, 90, device=True, annotation=True, linked=2),
    ]))
    assert tl.busy_s == 20e-9 and tl.window_s == 100e-9
    assert dict(tl.idle_gaps()) == {"group.resident_rows": 20e-9,
                                    "group": 50e-9,
                                    "phbench.group_files": 10e-9}
    assert tl.span_device_s("phbench.group_files") == 20e-9


class _Event:
    """A profiler event as tracing.Timeline reads one."""

    def __init__(self, name, start, dur, *, device=False, annotation=False,
                 corr=0, linked=0):
        import torch

        kind = torch.autograd.DeviceType
        self._v = {"name": name, "start_ns": start, "duration_ns": dur,
                   "device_type": kind.CUDA if device else kind.CPU,
                   "is_user_annotation": annotation,
                   "correlation_id": corr, "linked_correlation_id": linked,
                   "start_thread_id": 1}

    def __getattr__(self, key):
        return lambda: self._v[key]


class _Profile:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _: events})()
        self.profiler = type("P", (), {"kineto_results": results})()

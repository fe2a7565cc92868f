"""The traced window's reading on made-up profiler events: the device's
busy time, the idle time by what the host was doing, and the refusal of a
trace that lost kernel records, naming the kernel and both counts."""

import pytest

from gpubench import trace


class Event:
    def __init__(self, name, kind, start, dur, corr=0, thread=1):
        self._name, self._kind, self._start, self._dur, self._corr, self._thread = name, kind, start, dur, corr, thread

    def name(self):
        return self._name

    def device_type(self):
        on_device = self._kind in trace.DEVICE_KINDS + ("gpu_user_annotation",)
        return "DeviceType.CUDA" if on_device else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._thread


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda s: events})()})()


def events(drop_second=False):
    ev = [
        Event("bench:recommend_batch", "user_annotation", 0, 1000),
        Event("aten::mm", "cpu_op", 10, 50),
        Event("cudaLaunchKernel", "cuda_runtime", 20, 5, corr=1),
        Event("void (anonymous namespace)::score_submax_kernel<float, true, true, true>(float const*)", "kernel", 100, 300, corr=1),
        Event("cudaLaunchKernel", "cuda_runtime", 420, 5, corr=2),
        Event("aten::copy_", "cpu_op", 410, 100),
        Event("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 600, 100, corr=3),
    ]
    if not drop_second:
        ev.append(Event("void gather_rows_kernel<4>(float const*)", "kernel", 450, 50, corr=2))
    return ev


def test_busy_idle_and_breakdown():
    w = trace.Window(Prof(events()), 0, 1000)
    assert w.busy_s() == pytest.approx(450e-9)
    assert w.check({"score_submax_groupmax": 1, "gather_rows": 1}) == []
    br = w.breakdown()
    assert br["device_ops"][0][0] == "score_submax_kernel<float, true, true, true>"
    idle = dict(br["idle_gaps"])
    assert idle["recommend_batch/aten::mm"] == pytest.approx(100e-9)
    assert idle["recommend_batch/cudaLaunchKernel"] == pytest.approx(50e-9)
    assert sum(idle.values()) == pytest.approx(550e-9)


def test_a_lost_kernel_record_fails_the_trace():
    w = trace.Window(Prof(events(drop_second=True)), 0, 1000)
    with pytest.raises(trace.TraceLost, match="1 of 2 kernel launches"):
        w.check({"score_submax_groupmax": 1, "gather_rows": 1})


def test_a_counter_that_disagrees_names_the_kernel_and_both_counts():
    w = trace.Window(Prof(events()), 0, 1000)
    with pytest.raises(trace.TraceLost, match=r"score_submax_kernel: 1 device records in the window, 2 launches counted"):
        w.check({"score_submax_groupmax": 2, "gather_rows": 1})


@pytest.mark.parametrize("marked", [True, False])
def test_an_annotations_copy_on_the_device_is_no_kernel(marked):
    """Whatever its name, and also where the profiler does not mark the
    copy as an annotation's (it then bears the host annotation's name)."""
    ev = events() + [
        Event("hstu:block", "user_annotation", 100, 800),
        Event("hstu:block", "gpu_user_annotation" if marked else "kernel", 100, 800, corr=9),
    ]
    w = trace.Window(Prof(ev), 0, 1000)
    assert w.span_copies == {"hstu:block": 1}
    assert w.busy_s() == pytest.approx(450e-9)
    assert w.check({"score_submax_groupmax": 1, "gather_rows": 1}) == []

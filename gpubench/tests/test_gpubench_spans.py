"""The readers of the program's spans (``gpubench/spans.py`` and the
``prep_host_ms``, ``budget_host_ms`` and ``certify_device_ms`` metrics) on
made-up profiler events: spans clipped to the window, a kernel given to the
span its launch began in by correlation id, nothing read where the program
has no span, and an idle gap under a program span labelled by it in the
unchanged breakdown. On the card: a traced ``recommend`` whose spans' copies
on the device's timeline stay out of the window's device operations."""

import time

import pytest
from test_gpubench_trace import Event, Prof

from gpubench import spans, spec, trace


def _events(with_spans=True):
    ev = [
        Event("bench:recommend", "user_annotation", 0, 1000),
        Event("aten::mm", "cpu_op", 400, 10),
        Event("cudaLaunchKernel", "cuda_runtime", 402, 3, corr=1),
        Event("void score_submax_kernel<float, false, true, true>(float const*)", "kernel", 420, 300, corr=1),
        Event("cudaLaunchKernel", "cuda_runtime", 760, 3, corr=2),
        Event("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<float>)", "kernel", 770, 150, corr=2),
        Event("cudaLaunchKernel", "cuda_runtime", 780, 3, corr=3),
        Event("void at::native::elementwise_kernel<128, 4>(int)", "kernel", 930, 20, corr=3),
    ]
    if with_spans:
        ev += [
            Event("sbr.recommend_batch", "user_annotation", 5, 975),
            Event("sbr.serve.prepare", "user_annotation", -50, 150),  # clipped to 0-100
            Event("sbr.serve.budgets", "user_annotation", 110, 60),
            Event("sbr.tower.inputs", "user_annotation", 200, 30),
            Event("sbr.topk.certify", "user_annotation", 750, 25),  # launches 2, not 3
            Event("sbr.tower.inputs", "user_annotation", 1500, 30),  # past the window
        ]
    return ev


def _reading(with_spans=True, units=2):
    return {"window": trace.Window(Prof(_events(with_spans)), 0, 1000), "units": units}


def _read(metric, reading):
    return spec.metric_module(metric).read(reading, metric)


def test_host_spans_are_clipped_to_the_window():
    w = _reading()["window"]
    assert spans.intervals(w, "serve.prepare") == [(0, 100)]
    assert spans.intervals(w, "tower.inputs") == [(200, 230)]
    assert _read("prep_host_ms.recommend", _reading()) == pytest.approx(130e-6 / 2)
    assert _read("budget_host_ms.serve_batch", _reading()) == pytest.approx(60e-6 / 2)


def test_a_kernel_belongs_to_the_span_its_launch_began_in():
    w = _reading()["window"]
    assert [n for n, _ in spans.kernels_in(w, "topk.certify")] == [
        "void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<float>)"
    ]
    assert _read("certify_device_ms.recommend", _reading()) == pytest.approx(150e-6 / 2)


@pytest.mark.parametrize("metric", ["prep_host_ms.serve_batch", "budget_host_ms.recommend",
                                    "certify_device_ms.serve_batch"])
def test_nothing_is_read_without_the_span(metric):
    assert _read(metric, _reading(with_spans=False)) is None
    assert _read(metric, _reading(units=0)) is None


def test_an_idle_gap_under_a_program_span_is_labelled_by_it():
    idle = dict(_reading()["window"].breakdown()["idle_gaps"])
    assert idle["recommend/sbr.tower.inputs"] == pytest.approx(420e-9)  # 0-420: its midpoint in the span
    assert idle["recommend/sbr.recommend_batch"] == pytest.approx(110e-9)  # 720-770, 920-930, 950-1000
    assert not any(label.endswith("/-") for label in idle)


@pytest.mark.card
def test_program_spans_stay_off_the_device_timeline(card):
    """A traced ``recommend`` on a catalog past one chunk: the program's
    spans are on the host, none of their copies on the device's timeline is
    taken for a device operation, and ``certify_device_ms`` reads the
    kernels of the certificate."""
    import torch

    from sbr_rs_tpu_torch.models import lstm

    model = lstm.Hyperparameters(300_000, 8).embedding_dim(32).from_seed(0).build(card)
    hs = [[1, 2, 3], [7, 300, 42_000, 5], list(range(20))]
    for h in hs:
        model.recommend(h, k=10)
    with trace.session(cuda=True) as prof:
        t0 = time.time_ns()
        for h in hs:
            model.recommend(h, k=10)
        torch.cuda.synchronize()
        t1 = time.time_ns()
    w = trace.Window(prof, t0, t1)
    host = {name for _, _, name, _ in w.host}
    assert {"sbr.recommend_batch", "sbr.serve.budgets", "sbr.topk.certify"} <= host
    assert not [name for *_, name, _ in w.device if name.startswith(spans.PREFIX)]
    assert w.busy_s() < w.window_s
    assert _read("certify_device_ms.recommend", {"window": w, "units": len(hs)}) > 0

"""The port's timing and profiling helpers (advanced_rag_tpu_torch/utils/
timing.py and profiling.py) on the CPU.

One test for each of tests/test_timing.py's, with ``device="cpu"`` where a
timer takes a device: the eps chain stays data-dependent (a NaN in the
output reaches the zero), each timer returns a finite time, ``fetch_ms``
copies the part it is given, ``scanned_ms`` raises with no card unless
asked for the CPU.  ``StageTimer.report()`` equals the JAX package's on the
same samples under one patched clock, and ``device_trace`` with
``annotate`` writes a Chrome trace that names the range.
"""

import json
import math
import time

import numpy as np
import pytest
import torch

from advanced_rag_tpu.utils import profiling as j_profiling
from advanced_rag_tpu_torch.utils import profiling
from advanced_rag_tpu_torch.utils.timing import (chained_ms, fetch_ms, scanned_ms,
                                                 zero_scalar_of)


def test_zero_scalar_is_zero_but_data_dependent():
    out = {"scores": torch.tensor([[3.5, -2.0]]), "ids": torch.tensor([[1, 2]])}
    z = zero_scalar_of(out)
    assert z.item() == 0.0 and z.dtype == torch.float32 and z.dim() == 0
    # the zero carries the value it came from: a NaN reaches it, and so
    # does autograd
    assert math.isnan(zero_scalar_of({"s": torch.tensor([float("nan"), 1.0])}).item())
    x = torch.ones(4, requires_grad=True)
    assert zero_scalar_of((x * 2.0,)).grad_fn is not None
    with pytest.raises(ValueError):
        zero_scalar_of({"none": None})


def test_zero_scalar_int_leaf():
    z = zero_scalar_of(torch.tensor([7, 9], dtype=torch.int32))
    assert z.item() == 0.0 and z.dtype == torch.float32


def test_chained_ms_times_a_real_call():
    x = torch.ones((64, 64))
    calls = []

    def f(i, eps):
        calls.append(i)
        return (x + eps) @ x

    ms = chained_ms(f, rounds=3)
    assert ms >= 0.0 and np.isfinite(ms)
    assert calls == [0, 0, 1, 2]                  # the warm-up call, then 3 rounds


def test_scanned_ms_small_kernel(monkeypatch):
    ops = (torch.ones((128, 128)),)

    def f(eps, a):
        return (a + eps) @ a

    ms = scanned_ms(f, rounds=5, operands=ops, device="cpu")
    assert ms >= 0.0 and np.isfinite(ms)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scanned_ms(f, rounds=5, operands=ops)
    with pytest.raises(ValueError):
        scanned_ms(f, rounds=1, operands=ops, device="cpu")


def test_fetch_ms_full_and_partial():
    seen = []

    class Tracked(torch.Tensor):
        def cpu(self, *a, **k):
            seen.append(tuple(self.shape))
            return super().cpu(*a, **k)

    def f():
        return {"scores": torch.ones((8, 8)).as_subclass(Tracked),
                "ids": torch.zeros((8,), dtype=torch.int32).as_subclass(Tracked)}

    assert fetch_ms(f) >= 0.0
    assert sorted(seen) == [(8,), (8, 8)]
    seen.clear()
    assert fetch_ms(f, small=lambda r: r["ids"]) >= 0.0
    assert seen == [(8,)]


def test_service_main_module_imports():
    import advanced_rag_tpu_torch.service.__main__ as m

    assert callable(m.main)


def test_stage_timer_rolling_window():
    t = profiling.StageTimer(window=5)
    for _ in range(8):
        with t.stage("s"):
            pass
    rep = t.report()
    assert rep["s"]["count"] == 5
    assert rep["s"]["p50"] >= 0.0 and rep["s"]["p99"] >= rep["s"]["p50"]


def test_stage_timer_report_equals_jax(monkeypatch):
    """The same seeded stage lengths through both timers, one patched clock."""
    rng = np.random.default_rng(0)
    lengths = rng.exponential(3e-3, size=40).tolist()

    def drive(timer):
        ticks = iter(np.cumsum([0.0] + [x for d in lengths for x in (d, 1e-4)]).tolist())
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        for i, _ in enumerate(lengths):
            with timer.stage("embed" if i % 3 else "search"):
                pass
        monkeypatch.undo()
        return timer.report()

    got = drive(profiling.StageTimer(window=12))
    want = drive(j_profiling.StageTimer(window=12))
    assert got == want and set(got) == {"embed", "search"}


def test_device_trace_and_annotate(tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.annotate("matmul"):
            x = torch.ones((8, 8))
            (x @ x).sum().item()
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "matmul" for e in events)
    assert "matmul" in {e.key for e in prof.key_averages()}


def test_annotate_decorates(monkeypatch):
    @profiling.annotate("decorated")
    def f(a, b=2):
        return a + b

    # with no profiler running, no record_function is entered at all
    def refuse(name):
        raise AssertionError("record_function entered with no profiler")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        assert f(1) == 3

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert f(1, b=3) == 4
    assert "decorated" in {e.key for e in prof.key_averages()}
    assert f.__name__ == "f"

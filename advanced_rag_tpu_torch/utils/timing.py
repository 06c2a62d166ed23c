"""Device timing for the port: CUDA-graph, eps-chain and fetch timers.

CUDA launches return before the device has run them, so a host clock
around a call measures the enqueue.  These helpers time work in three
sound ways:

- ``scanned_ms``: per-call DEVICE ms.  On the card, ``rounds`` calls
  chained through a zero-valued eps are captured in one CUDA graph and a
  graph of one call beside it; the difference of their replays (CUDA
  events) over ``rounds - 1`` cancels the replay's fixed cost, and no
  host launch overhead is in it.  ``device="cpu"`` times the same chain
  on the host clock.
- ``chained_ms``: amortized per-call wall ms with the host's launch
  overhead in it: each call folds in a zero-valued f32 scalar derived
  from the previous call's output, so the calls form a data-dependent
  chain, and ONE ``.item()`` fetch at the end forces the whole chain.
- ``fetch_ms``: single-call blocking latency: the timed region ends with
  a device-to-host copy of (a small part of) the output, what a serving
  host does with results.

The port's copy of ``advanced_rag_tpu/utils/timing.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import torch

__all__ = ["zero_scalar_of", "chained_ms", "fetch_ms", "scanned_ms"]


def _leaves(x: Any) -> List[torch.Tensor]:
    """The tensors of ``x`` (a tensor, or dicts, lists, tuples and
    dataclasses of them), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        vals = list(x.values())
    elif isinstance(x, (list, tuple)):
        vals = list(x)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        vals = [getattr(x, f.name) for f in dataclasses.fields(x)]
    else:
        return []
    return [leaf for v in vals for leaf in _leaves(v)]


def zero_scalar_of(out: Any) -> torch.Tensor:
    """A 0-d f32 tensor that is always 0.0 but data-depends on ``out``.

    Uses one element of the first tensor of ``out``: ``min(|v|, 0)``,
    computed as ``clamp(v, 0, 0)`` (the same value, 0.0 for any non-NaN v,
    in one kernel).  The chain never waits on the host.
    """
    leaves = _leaves(out)
    if not leaves:
        raise ValueError("zero_scalar_of needs an output holding a tensor")
    v = leaves[0].reshape(-1)[:1].float()
    return torch.clamp(v, 0.0, 0.0).reshape(())


def chained_ms(make_call: Callable[[int, torch.Tensor], Any], rounds: int = 10) -> float:
    """Amortized per-call wall ms of ``make_call(i, eps)``.

    ``make_call`` MUST fold ``eps`` (a zero f32 scalar carrying a data
    dependence on the previous call) into its inputs, e.g.
    ``lambda i, eps: f(q[i] + eps)``.  The first call (build, warm-up) is
    excluded; one ``.item()`` at the end forces the whole chain.
    """
    eps = zero_scalar_of(make_call(0, torch.zeros(())))
    eps.item()
    t0 = time.perf_counter()
    for i in range(rounds):
        eps = zero_scalar_of(make_call(i, eps))
    if eps.item() != 0.0:  # the one synchronizing fetch
        raise AssertionError("the eps chain did not stay zero")
    return (time.perf_counter() - t0) / rounds * 1e3


def _resolve(device: Optional[str]) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("scanned_ms times the CUDA card, and there is none; "
                           "pass device='cpu' to time the chain on the host clock")
    return torch.device("cuda", torch.cuda.current_device())


def scanned_ms(fn: Callable[..., Any], rounds: int = 20, operands: tuple = (),
               device: Optional[str] = None) -> float:
    """Per-call device ms of ``fn(eps, *operands)``, the calls chained
    through ``eps`` (fold it into an input as ``chained_ms`` asks).

    On the card: one CUDA graph of ``rounds`` chained calls and one of a
    single call, each replayed three times between CUDA events; (best of
    ``rounds`` - best of 1) / (rounds - 1).  With ``device="cpu"``: the
    same chains on the host clock.  With no card and no ``device``, it
    raises rather than time the host.
    """
    if rounds < 2:
        raise ValueError("scanned_ms differences two chain lengths; rounds >= 2")
    dev = _resolve(device)

    def chain(eps: torch.Tensor, length: int) -> torch.Tensor:
        for _ in range(length):
            eps = zero_scalar_of(fn(eps, *operands))
        return eps

    zero = torch.zeros((), device=dev)
    if dev.type != "cuda":
        def best(length: int) -> float:
            chain(zero, length).item()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                if chain(zero, length).item() != 0.0:
                    raise AssertionError("the eps chain did not stay zero")
                times.append(time.perf_counter() - t0)
            return min(times)
    else:
        def best(length: int) -> float:
            chain(zero, 1)
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="relaxed"):
                out = chain(zero, length)
            graph.replay()
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            times = []
            for _ in range(3):
                start.record()
                graph.replay()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            if out.item() != 0.0:
                raise AssertionError("the eps chain did not stay zero")
            del graph
            return min(times)

    return max(best(rounds) - best(1), 0.0) / (rounds - 1) * 1e3


def fetch_ms(call: Callable[[], Any], small: Optional[Callable[[Any], Any]] = None) -> float:
    """Blocking single-call wall ms, ended by a device-to-host copy of the
    output's tensors, or of ``small(out)``'s (e.g. ``lambda r: r.ids``: the
    part a server fetches)."""
    t0 = time.perf_counter()
    out = call()
    for t in _leaves(small(out) if small is not None else out):
        t.cpu()
    return (time.perf_counter() - t0) * 1e3

"""Query micro-batching: coalesce concurrent searches into one dispatch.

A copy of ``advanced_rag_tpu/pipeline/batcher.py`` in the PyTorch port, which never
imports the JAX package.

The reference handles concurrency with per-request asyncio fan-out
(service.py:137-149 semaphore(64)); on an accelerator the winning shape
is the opposite — ONE fused program over a query batch (measured: batch-8
hybrid search gives ~8x the single-query throughput at ~equal latency).

Continuous-batching protocol (the vLLM-style shape, not leader/follower):
requests enqueue per batch key and a small pool of dispatcher threads
drains them.  While a dispatch is in flight (~tens of ms on the device),
new arrivals accumulate; the next grab takes EVERYTHING queued up to
``max_batch``, so the batch size adapts to load automatically — batch-1
at low load (latency-optimal), full buckets under pressure
(throughput-optimal).  The earlier leader-follower design waited a fixed
few-ms window instead, which under closed-loop load coalesced only ~1.3
queries/batch: every arrival during the in-flight window became a new
batch-of-1 leader serialized on the device queue (measured 52 QPS at
p50 452 ms; see scripts/bench_service_load.py).

Requests only coalesce when their ENTIRE knob set (k, weights, mmr,
filters) matches, so semantics are identical to unbatched execution.

Starvation bound (age-based grab): the dispatcher normally drains the
LONGEST queue — largest batch first maximizes device utilization — and
only grabs when idle or when a FULL batch is queued (grabbing partial
batches while a dispatch is in flight measurably halves QPS: the
accumulating queue splits into two half-size dispatches and per-
dispatch overhead dominates).  Under sustained saturation that rule
alone starves minority knob-sets: a batch-of-1 waits behind a majority
key that keeps refilling (the 300 ms degrade budget then converts the
wait into silent empty results).  So a third
grab trigger exists: any queue whose HEAD request has waited longer
than ``max_age_s`` becomes grabbable immediately and is drained FIRST
(oldest head wins over longest queue).  Majority traffic loses at most
one minority-sized dispatch per ``max_age_s``, so throughput cost is
bounded by the minority's share; minority wait is bounded by
``max_age_s`` + one in-flight dispatch (tested with a 90/10 knob mix
in tests/test_batcher.py).
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Tuple

#: (query, result future, enqueue timestamp)
_Entry = Tuple[str, concurrent.futures.Future, float]


class MicroBatcher:
    """Coalesces ``submit`` calls that share a key into one batch call.

    ``max_inflight`` dispatcher threads allow that many device dispatches
    to overlap (host fan-out + transfer of batch N pipelines with device
    compute of batch N+1).  The port's default is one: its batch is
    eager PyTorch whose host work outlasts the device's (the device idles
    most of a batch), so a second dispatch in flight overlaps no device
    work; it only contends for the interpreter lock, which each torch op
    releases, and both batches slow down.
    """

    def __init__(
        self,
        batch_fn: Callable[..., List[Any]],
        # batch_fn(queries: list[str], **kwargs) -> list of per-query results
        max_batch: int = 8,
        max_wait_s: float = 0.002,  # kept for config compat; unused now
        max_inflight: int = 1,
        max_age_s: float = 0.05,
    ):
        self._batch_fn = batch_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_age_s = max_age_s
        self._cv = threading.Condition()
        #: key -> (kwargs, [(query, future, enqueue_ts), ...])
        self._queues: Dict[Hashable, Tuple[Dict[str, Any], List[_Entry]]] = {}
        self._closed = False
        self._inflight = 0
        self.stats = {"batches": 0, "requests": 0, "max_seen": 0,
                      "aged_grabs": 0}
        self._threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name=f"microbatch-{i}")
            for i in range(max(1, max_inflight))
        ]
        for t in self._threads:
            t.start()

    def submit(self, key: Hashable, query: str, **kwargs: Any) -> Any:
        """Block until this query's result is available.  ``kwargs`` must
        be identical for every request sharing ``key`` (the key should be
        derived from them)."""
        future: concurrent.futures.Future = concurrent.futures.Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if key not in self._queues:
                self._queues[key] = (dict(kwargs), [])
            self._queues[key][1].append((query, future, time.monotonic()))
            self._cv.notify()
        return future.result()

    def close(self) -> None:
        """Stop dispatcher threads; pending requests get an exception."""
        with self._cv:
            self._closed = True
            pending = list(self._queues.values())
            self._queues.clear()
            self._cv.notify_all()
        for _, entries in pending:
            for _, f, _t in entries:
                if not f.done():
                    f.set_exception(RuntimeError("MicroBatcher closed"))
        for t in self._threads:
            t.join(timeout=5.0)

    # -- dispatcher ---------------------------------------------------------

    def _aged_key(self, now: float):
        """Under ``_cv``: the key whose head request has waited past
        ``max_age_s`` longest, or None (the anti-starvation trigger)."""
        aged = [(v[1][0][2], k) for k, v in self._queues.items()
                if v[1] and now - v[1][0][2] >= self.max_age_s]
        return min(aged)[1] if aged else None

    def _take_batch(self) -> Tuple[Any, Dict[str, Any], List[_Entry]]:
        """Under ``_cv``: pop up to ``max_batch`` entries from the aged
        queue if one exists (oldest head first — bounded wait), else the
        longest queue (largest batch first maximizes device utilization)."""
        key = self._aged_key(time.monotonic())
        if key is not None:
            self.stats["aged_grabs"] += 1
        else:
            key = max(self._queues, key=lambda k: len(self._queues[k][1]))
        kwargs, entries = self._queues[key]
        batch, rest = entries[: self.max_batch], entries[self.max_batch:]
        if rest:
            self._queues[key] = (kwargs, rest)
        else:
            del self._queues[key]
        return key, kwargs, batch

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                # Grab when nothing is in flight (latency path: batch-1
                # immediately) or when a FULL batch is queued (throughput
                # path: overlap full dispatches only).  Grabbing a
                # partial batch while another dispatch is in flight
                # splits the accumulating queue into two half-size
                # dispatches, and per-dispatch overhead dominates device
                # compute — measured avg batch 7.6/16 and ~½ the
                # achievable QPS before this gate.
                #
                # The wait sleeps until a submit, a finished dispatch or
                # the oldest head's age deadline, not in 1 ms polls: in
                # this port the batch thread releases the interpreter
                # lock at every torch op and kernel launch, and each poll
                # that takes the lock then delays the batch.
                while not self._closed:
                    timeout = None
                    if self._queues:
                        now = time.monotonic()
                        qlen = max(len(v[1]) for v in self._queues.values())
                        if (self._inflight == 0
                                or qlen >= self.max_batch
                                or self._aged_key(now) is not None):
                            break
                        oldest = min(v[1][0][2] for v in self._queues.values())
                        timeout = oldest + self.max_age_s - now
                    self._cv.wait(timeout)
                if self._closed:
                    return
                _key, kwargs, batch = self._take_batch()
                if self._queues:
                    self._cv.notify()   # another thread times what is left
                self._inflight += 1
                self.stats["batches"] += 1
                self.stats["requests"] += len(batch)
                self.stats["max_seen"] = max(self.stats["max_seen"],
                                             len(batch))
            queries = [q for q, _, _ in batch]
            try:
                results = self._batch_fn(queries, **kwargs)
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results for "
                        f"{len(batch)} queries")
            except Exception as exc:
                for _, f, _t in batch:
                    if not f.done():
                        f.set_exception(exc)
                results = None
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()
            if results is not None:
                for (_, f, _t), res in zip(batch, results):
                    f.set_result(res)


__all__ = ["MicroBatcher"]

"""Dynamic request batching for grasp-generation serving.

A copy of :mod:`graspldm_tpu.serving.batcher` (stdlib + numpy only): the
JAX package's copy is unreachable without JAX, because its ``serving`` and
``utils`` sub-package ``__init__`` files import JAX. Requests queue on the
host; a worker thread gathers them for up to ``max_wait_ms``, pads the batch
to a fixed bucket size (powers of two), runs ONE generation call and routes
the per-object slices back to the callers' futures.

The batch function is an injected callable ``batch_generate(pc [B, N, 3]
float32, cls [B] | None) -> dict`` whose array values carry a leading ``B``
dim (see :func:`graspldm_tpu_torch.serving.server.make_batch_generate_from_parts`).
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["DynamicBatcher", "BatcherStats"]


@dataclass
class _Pending:
    pc: np.ndarray  # [num_points, 3] metric points, already regularized
    num_grasps: int
    cls_cond: Optional[float]
    future: Future
    t_enqueue: float = field(default_factory=time.perf_counter)


def _default_buckets(max_batch: int) -> List[int]:
    """Powers of two up to ``max_batch`` (always including ``max_batch``)."""
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return buckets


@dataclass
class BatcherStats:
    requests: int = 0
    batches: int = 0
    errors: int = 0
    batch_size_hist: Dict[int, int] = field(default_factory=dict)
    latency_p50_ms: Optional[float] = None
    latency_p95_ms: Optional[float] = None
    queue_depth: int = 0

    def as_dict(self) -> Dict:
        return {
            "requests": self.requests,
            "batches": self.batches,
            "errors": self.errors,
            "batch_size_hist": dict(self.batch_size_hist),
            "latency_p50_ms": self.latency_p50_ms,
            "latency_p95_ms": self.latency_p95_ms,
            "queue_depth": self.queue_depth,
        }


class DynamicBatcher:
    """Gather concurrent generation requests into fixed-bucket batches.

    Args:
        batch_generate: ``(pc [B, N, 3] float32, cls [B] float32 | None)
            -> dict`` of numpy-convertible arrays with leading dim ``B``
            (at minimum ``grasps [B, G, 4, 4]`` and ``confidence [B, G]``).
            Called from the single worker thread only — it may own
            non-thread-safe state (CUDA streams, generators).
        num_points: fixed point count N every request is regularized to.
        max_batch: largest batch bucket.
        max_wait_ms: how long the worker waits to fill a batch after the
            first request arrives. 0 disables coalescing (batch = whatever
            is already queued).
        buckets: explicit batch buckets (sorted ascending). Default:
            powers of two up to ``max_batch``.
        requires_cls: ``True`` → every request must carry ``cls_cond``
            (class-conditioned model), ``False`` → none may (unconditional
            model); validated at :meth:`submit` so a bad request fails
            itself immediately instead of depending on what it happens to
            be co-batched with. ``None`` (unknown model) skips validation;
            the worker then coalesces per cls-presence group (the queue
            head picks the group) so batch composition never changes a
            request's semantics and mixed traffic still fills batches.
    """

    def __init__(
        self,
        batch_generate: Callable[[np.ndarray, Optional[np.ndarray]], Dict],
        num_points: int = 1024,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        buckets: Optional[Sequence[int]] = None,
        requires_cls: Optional[bool] = None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._fn = batch_generate
        self.requires_cls = requires_cls
        self.num_points = int(num_points)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.buckets = sorted(buckets) if buckets else _default_buckets(max_batch)
        if self.buckets[-1] < self.max_batch:
            raise ValueError("largest bucket must cover max_batch")

        self._queue: collections.deque[_Pending] = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._latencies: collections.deque[float] = collections.deque(maxlen=512)
        self._stats = BatcherStats()
        self._worker = threading.Thread(
            target=self._run, name="graspldm-batcher", daemon=True
        )
        self._worker.start()

    # -- client API --

    def submit(
        self,
        pc: np.ndarray,
        num_grasps: int,
        cls_cond: Optional[float] = None,
    ) -> Future:
        """Enqueue one object's point cloud; resolves to its result dict.

        ``pc`` is a metric ``[N0, 3]`` cloud with any N0 >= 1; it is
        regularized to ``num_points`` here (subsample / pad-by-resample,
        reference `pointcloud_helpers.py:124-160`). Normalization happens
        inside the batch function.
        """
        from ..utils.pointcloud_helpers import regularize_pc_point_count

        if self.requires_cls is True and cls_cond is None:
            raise ValueError(
                "class-conditioned model: every request needs 'cls'"
            )
        if self.requires_cls is False and cls_cond is not None:
            raise ValueError(
                "this model is not class-conditioned; drop the 'cls' field"
            )
        pc = np.asarray(pc, np.float32)
        if pc.ndim != 2 or pc.shape[1] != 3 or pc.shape[0] < 1:
            raise ValueError(f"pc must be [N, 3] with N >= 1, got {pc.shape}")
        if not np.isfinite(pc).all():
            raise ValueError("pc contains non-finite values")
        pc = regularize_pc_point_count(pc, self.num_points)
        fut: Future = Future()
        item = _Pending(pc, int(num_grasps), cls_cond, fut)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append(item)
            self._stats.requests += 1
            self._cv.notify()
        return fut

    def generate(
        self,
        pc: np.ndarray,
        num_grasps: int,
        cls_cond: Optional[float] = None,
        timeout: Optional[float] = None,
    ) -> Dict:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(pc, num_grasps, cls_cond).result(timeout=timeout)

    def stats(self) -> Dict:
        with self._cv:
            s = BatcherStats(
                requests=self._stats.requests,
                batches=self._stats.batches,
                errors=self._stats.errors,
                batch_size_hist=dict(self._stats.batch_size_hist),
                queue_depth=len(self._queue),
            )
            lats = sorted(self._latencies)
        if lats:
            s.latency_p50_ms = round(lats[len(lats) // 2] * 1e3, 2)
            s.latency_p95_ms = round(lats[int(len(lats) * 0.95)] * 1e3, 2)
        return s.as_dict()

    def close(self, timeout: float = 5.0) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=timeout)

    # -- worker --

    def _head_group_size(self) -> int:
        """Queued requests matching the head's cls-presence (cv held)."""
        if not self._queue:
            return 0
        head = self._queue[0].cls_cond is not None
        return sum(
            1 for it in self._queue if (it.cls_cond is not None) == head
        )

    def _collect(self) -> Optional[List[_Pending]]:
        """Block for the first request, then coalesce up to the deadline."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait(timeout=0.1)
            if not self._queue:
                return None  # closed and drained
            deadline = time.perf_counter() + self.max_wait_s
            # the batch below holds only requests matching the queue head's
            # cls-presence, so the fill criterion must count THAT group —
            # counting the whole queue would fire a half-full batch as soon
            # as interleaved cls/no-cls traffic reaches max_batch in total
            while self._head_group_size() < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or self._closed:
                    break
                self._cv.wait(timeout=remaining)
            # coalesce only requests matching the queue head's cls-presence
            # (relevant with requires_cls=None and mixed traffic: grouping
            # here keeps batches full instead of splitting every batch in
            # two at execution time); skipped requests keep their place at
            # the front of the queue
            batch: List[_Pending] = []
            head_has_cls = self._queue[0].cls_cond is not None
            skipped: List[_Pending] = []
            while self._queue and len(batch) < self.max_batch:
                it = self._queue.popleft()
                if (it.cls_cond is not None) == head_has_cls:
                    batch.append(it)
                else:
                    skipped.append(it)
            for it in reversed(skipped):
                self._queue.appendleft(it)
            return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            # a request's conditioning must not depend on who it was
            # coalesced with. _collect() already gathers a cls-uniform
            # batch; this split is a defensive invariant (it is a no-op
            # for uniform batches)
            with_cls = [it for it in batch if it.cls_cond is not None]
            without = [it for it in batch if it.cls_cond is None]
            for group in (with_cls, without):
                if group:
                    self._execute(group)

    def _execute(self, batch: List[_Pending]) -> None:
        n = len(batch)
        bucket = next(b for b in self.buckets if b >= n)
        pcs = np.stack(
            [item.pc for item in batch]
            + [batch[-1].pc] * (bucket - n)  # pad rows are discarded below
        )
        cls = None
        if any(item.cls_cond is not None for item in batch):
            cls = np.asarray(
                [
                    item.cls_cond if item.cls_cond is not None else 0.0
                    for item in batch
                ]
                + [0.0] * (bucket - n),
                np.float32,
            )
        try:
            out = self._fn(pcs, cls)
            results = {k: np.asarray(v) for k, v in out.items() if v is not None}
        except Exception as e:  # propagate to every caller; keep serving
            with self._cv:
                self._stats.errors += n
            for item in batch:
                if not item.future.cancelled():
                    item.future.set_exception(e)
            return
        now = time.perf_counter()
        with self._cv:
            self._stats.batches += 1
            h = self._stats.batch_size_hist
            h[bucket] = h.get(bucket, 0) + 1
            for item in batch:
                self._latencies.append(now - item.t_enqueue)
        for i, item in enumerate(batch):
            res = {}
            for k, v in results.items():
                vi = v[i]
                # per-grasp axes are sliced down to the request's count
                if vi.ndim >= 1 and vi.shape[0] >= item.num_grasps and k in (
                    "grasps",
                    "grasp_tmrp",
                    "confidence",
                    "qualities",
                ):
                    vi = vi[: item.num_grasps]
                res[k] = vi
            if not item.future.cancelled():
                item.future.set_result(res)

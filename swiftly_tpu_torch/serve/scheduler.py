"""Column-locality-aware coalescing scheduler.

The port of the JAX package's ``swiftly_tpu/serve/scheduler.py``; its
dispatch-shape bucket is the plan's (`plan.model.bucket_shape`).

The engine's cost shape makes the scheduling policy: computing a
subgrid costs one column extraction (``extract_columns_batch`` over the
whole facet stack — the dominant term) plus one small finish per
subgrid, and the extraction is shared by *every* subgrid with the same
column offset ``off0``. "Large-Scale DFT on TPUs" (arXiv:2002.03260)
wins throughput by keeping device programs batched and dense even when
demand is sparse; here that means ragged arrival order must be
re-shaped into dense per-column programs. So the scheduler:

1. **times out** nothing itself (the queue owns deadlines) but serves
   *urgent* columns first — any column holding a request whose deadline
   is within ``urgency_s`` of now, earliest deadline first (EDF among
   the urgent);
2. otherwise prefers **hot** columns — columns whose intermediates are
   still resident in the forward's LRU (`SwiftlyForward.lru`): those
   requests skip the extraction entirely;
3. otherwise picks the column maximising ``(max priority, pending
   count, age)`` — the densest batch the queue can offer.

Batches are **bucket-padded** to the next power of two (by repeating
the first request's config; the padded rows are computed and discarded)
so the stacked column program sees O(log max_batch) distinct shapes
instead of one per batch size (the reference's compile-cache discipline;
eager PyTorch compiles nothing, but the shapes stay few). Padding by
repetition is exact: each batch lane is independent,
so the real rows are bit-identical with or without the pads (pinned by
the reference's tests/test_serve.py).

`plan_fused` additionally groups a multi-column take with
`api._group_columns` and pads ragged columns with
`api._pad_ragged_columns` — the same exact zero-mask padding the fused
whole-cover programs use — for services that trade per-request latency
for one fused dispatch over several columns.
"""

from __future__ import annotations

from ..api import _group_columns, _pad_ragged_columns
from ..plan.model import bucket_shape

__all__ = ["CoalescingScheduler", "bucket_shape"]


class CoalescingScheduler:
    """Pick-next-column policy + batch shaping for `SubgridService`.

    :param max_batch: cap on requests per column dispatch (overflow
        stays queued for the next pump)
    :param bucket_pad: pad batches to bucketed sizes to bound the
        number of compiled program shapes
    :param urgency_s: deadline head-start — a column holding a request
        due within this many seconds preempts locality/density order;
        None disables deadline preemption
    :param bucket_sizes: explicit ascending dispatch shapes (e.g. a
        compiled plan's ``serve.bucket_sizes``); None keeps the
        power-of-two default (`bucket_shape`)
    """

    def __init__(self, max_batch=64, bucket_pad=True, urgency_s=None,
                 bucket_sizes=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = int(max_batch)
        self.bucket_pad = bool(bucket_pad)
        self.urgency_s = urgency_s
        self.bucket_sizes = (
            None if bucket_sizes is None
            else sorted(int(b) for b in bucket_sizes)
        )

    # -- column selection ---------------------------------------------------

    def pick_column(self, summaries, hot_columns, now):
        """The next column to serve, or None when nothing is pending.

        :param summaries: `AdmissionQueue.columns()` snapshot
        :param hot_columns: set of off0 whose intermediates are LRU-hot
        """
        if not summaries:
            return None
        if self.urgency_s is not None:
            urgent = [
                s for s in summaries
                if s.min_deadline_t is not None
                and s.min_deadline_t - now <= self.urgency_s
            ]
            if urgent:
                return min(urgent, key=lambda s: s.min_deadline_t).off0
        hot = [s for s in summaries if s.off0 in hot_columns]
        pool = hot or summaries
        # densest batch wins; priority breaks ties, then age (oldest
        # arrival first) so no column starves under a steady hot stream
        best = max(
            pool,
            key=lambda s: (s.max_priority, s.count, -s.oldest_submit_t),
        )
        return best.off0

    def pick_columns(self, summaries, hot_columns, now, k):
        """Up to ``k`` columns for one fused multi-column dispatch:
        the `pick_column` winner plus the next densest columns."""
        first = self.pick_column(summaries, hot_columns, now)
        if first is None:
            return []
        rest = sorted(
            (s for s in summaries if s.off0 != first),
            key=lambda s: (-s.max_priority, -s.count, s.oldest_submit_t),
        )
        return [first] + [s.off0 for s in rest[: max(0, k - 1)]]

    # -- batch shaping ------------------------------------------------------

    def plan_batch(self, requests):
        """Order one column's take and shape its dispatch.

        :return: ``(configs, n_pad)`` — the config list to hand to the
            stacked column program (real requests first, then ``n_pad``
            bucket-padding repeats of the first config whose output rows
            are discarded).
        """
        configs = [r.config for r in requests]
        n_pad = 0
        if self.bucket_pad and len(configs) > 1:
            if self.bucket_sizes is not None:
                target = next(
                    (b for b in self.bucket_sizes if b >= len(configs)),
                    self.bucket_sizes[-1],
                )
                target = min(target, self.max_batch)
            else:
                target = min(bucket_shape(len(configs)), self.max_batch)
            n_pad = max(0, target - len(configs))
            configs = configs + [configs[0]] * n_pad
        return configs, n_pad

    def plan_fused(self, requests):
        """Shape a multi-column take for one fused dispatch.

        Groups by column with `api._group_columns` and pads ragged
        columns to rectangular with `api._pad_ragged_columns` (exact
        zero-mask entries). Returns ``(configs, rows)``: the flat
        config list (pads included) and, per request, the row index its
        result lands in. Raises ValueError on mixed subgrid sizes —
        the fused stacked output needs one size (callers fall back to
        per-column batches).
        """
        groups, rectangular = _group_columns(
            enumerate(requests),
            key=lambda item: item[1].config,
            require_one_size=True,
        )
        # _pad_ragged_columns works on (index, SubgridConfig) items
        cfg_groups = {
            off0: [(i, r.config) for i, r in col]
            for off0, col in groups.items()
        }
        if not rectangular:
            _pad_ragged_columns(
                cfg_groups, requests[0].config.size
            )
        configs, rows = [], {}
        for col in cfg_groups.values():
            for i, cfg in col:
                if i is not None:
                    rows[i] = len(configs)
                configs.append(cfg)
        return configs, [rows[i] for i in range(len(requests))]

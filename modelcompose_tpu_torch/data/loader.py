"""Prefetching data loader (the port's copy of
modelcompose_tpu/data/loader.py).

Plays the role of the reference's torch DataLoader worker pool (reference:
SURVEY.md §3.1 "[PROCESS BOUNDARY: dataloader workers; CPU-bound decode]"):
media decode (PIL/cv2/fbank/npy — C paths that release the GIL) runs in a
thread pool that stays ``prefetch`` batches ahead of the training loop.
The threads run only the collator; every CUDA call stays on the consumer's
thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Sequence

_SENTINEL = object()


class PrefetchLoader:
    """Iterate ``collate(dataset[i] for i in batch)`` with background
    workers.

    Args:
      dataset: indexable with __getitem__/__len__.
      order: iterable of sample indices (from train/sampler.py).
      batch_size: samples per batch (trailing partial batch dropped, like
        the reference's dataloader_drop_last).
      collate: callable on a list of samples.
      num_workers: decode threads; 0 = synchronous.
      prefetch: max batches queued ahead.
    """

    def __init__(self, dataset, order: Sequence[int], batch_size: int,
                 collate: Callable, num_workers: int = 4, prefetch: int = 4):
        self.dataset = dataset
        self.order = list(order)
        self.batch_size = batch_size
        self.collate = collate
        self.num_workers = num_workers
        self.prefetch = prefetch

    def _batches(self) -> List[List[int]]:
        B = self.batch_size
        return [self.order[i:i + B]
                for i in range(0, len(self.order) - B + 1, B)]

    def __len__(self) -> int:
        return len(self._batches())

    def __iter__(self) -> Iterator:
        batches = self._batches()
        if self.num_workers <= 0:
            for idxs in batches:
                yield self.collate([self.dataset[i] for i in idxs])
            return

        # maxsize=0 would mean UNBOUNDED for queue.Queue — clamp so
        # prefetch=0 still back-pressures at one batch ahead.
        out_q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        task_q: "queue.Queue" = queue.Queue()
        results = {}  # guarded by emit_cv (all access under its lock)
        next_emit = [0]
        stop = [False]  # set when the consumer exits early (close/exception)
        emit_cv = threading.Condition()

        for bi, idxs in enumerate(batches):
            task_q.put((bi, idxs))
        for _ in range(self.num_workers):
            task_q.put(_SENTINEL)

        window = max(self.prefetch, 1) + self.num_workers

        def worker():
            while True:
                item = task_q.get()
                if item is _SENTINEL:
                    return
                bi, idxs = item
                # Bound look-ahead relative to the emit cursor.  The gate is
                # on the batch INDEX, so the smallest outstanding batch can
                # always proceed — no deadlock when later batches finish
                # first.
                with emit_cv:
                    emit_cv.wait_for(
                        lambda: stop[0] or bi < next_emit[0] + window)
                    if stop[0]:
                        return
                try:
                    batch = self.collate([self.dataset[i] for i in idxs])
                except Exception as e:  # surfaced on the consumer side
                    batch = e
                with emit_cv:
                    results[bi] = batch
                    emit_cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        def emitter():
            for bi in range(len(batches)):
                with emit_cv:
                    emit_cv.wait_for(lambda: stop[0] or bi in results)
                    if stop[0]:
                        return
                    batch = results.pop(bi)
                    next_emit[0] = bi + 1
                    emit_cv.notify_all()  # open the look-ahead window
                # Poll the stop flag so a departed consumer (full out_q)
                # cannot park this thread forever holding batch data.
                while not stop[0]:
                    try:
                        out_q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
            out_q.put(_SENTINEL)

        emit_thread = threading.Thread(target=emitter, daemon=True)
        emit_thread.start()

        try:
            while True:
                item = out_q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # Early exit (consumer break / exception / generator close):
            # release parked workers and the emitter, drop queued batches.
            with emit_cv:
                stop[0] = True
                emit_cv.notify_all()
            while True:
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
            for t in threads:
                t.join(timeout=5.0)
            emit_thread.join(timeout=5.0)

"""Threaded writer queue (reference: data_proc/hloc/utils.py WorkQueue).

Serializes cache writes on a worker thread so device compute overlaps
cache IO during extraction loops."""

from __future__ import annotations

import queue
import threading


class WorkQueue:
    def __init__(self, work_fn, num_threads: int = 1, maxsize: int = 16):
        self._queue: queue.Queue = queue.Queue(maxsize)
        self._work_fn = work_fn
        self._threads = [
            threading.Thread(target=self._loop, daemon=True) for _ in range(num_threads)
        ]
        self._error = None
        for t in self._threads:
            t.start()

    def _loop(self):
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                break
            try:
                self._work_fn(item)
            except Exception as e:  # surface on join
                self._error = e
            self._queue.task_done()

    def put(self, item):
        if self._error:
            raise self._error
        self._queue.put(item)

    def join(self):
        for _ in self._threads:
            self._queue.put(None)
        self._queue.join()
        for t in self._threads:
            t.join()
        if self._error:
            raise self._error

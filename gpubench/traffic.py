"""The closed-loop generator: `clients` images outstanding at all times.

Each completed image's callback (on the batcher's collector thread)
submits the next image of the pool, which is cycled; no thread a client.
Every image is timed from its submit to its future's result. While the
window is open, a share of the completions, drawn from the seed, is kept
(its results copied out of the batch's buffers) for the check.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


class ClosedLoop:
    def __init__(self, submit, pool: np.ndarray, clients: int,
                 rng: np.random.Generator, keep: float):
        self.submit = submit
        self.pool = pool
        self.clients = clients
        self.rng = rng
        self.keep_share = keep
        self.lock = threading.Lock()
        self.done = threading.Condition(self.lock)
        self.next = 0
        self.completed = 0
        self.in_flight = 0
        self.stopping = False
        self.window: Optional[Tuple[float, float]] = None
        # (submit, done, ok) of every image done while the window was open
        self.records: List[Tuple[float, float, bool]] = []
        self.kept: List[Tuple[int, Dict[str, np.ndarray]]] = []

    def start(self) -> None:
        for _ in range(self.clients):
            self._send()

    def _send(self) -> None:
        with self.lock:
            idx = self.next % len(self.pool)
            self.next += 1
            self.in_flight += 1
        t = time.perf_counter()
        fut = self.submit(self.pool[idx])
        fut.add_done_callback(lambda f: self._done(f, idx, t))

    def _done(self, fut, idx: int, t_submit: float) -> None:
        t = time.perf_counter()
        ok = fut.exception() is None
        with self.lock:
            self.completed += 1
            self.in_flight -= 1
            open_ = self.window is not None and self.window[1] == 0.0
            if open_:
                self.records.append((t_submit, t, ok))
                if ok and self.rng.random() < self.keep_share:
                    self.kept.append((idx, {k: np.array(v) for k, v in
                                            fut.result().items()}))
            stop = self.stopping
            self.done.notify_all()
        if not stop:
            self._send()

    def wait_completed(self, n: int, timeout: float = 600.0) -> None:
        with self.lock:
            if not self.done.wait_for(lambda: self.completed >= n, timeout):
                raise RuntimeError(f"{self.completed} of {n} warm-in images "
                                   f"done in {timeout} s")

    def open_window(self) -> float:
        with self.lock:
            t = time.perf_counter()
            self.window = (t, 0.0)
        return t

    def close_window(self) -> float:
        with self.lock:
            t = time.perf_counter()
            self.window = (self.window[0], t)
            self.stopping = True
        return t

    def drain(self, timeout: float) -> bool:
        """Wait for every image in flight; False if some never came."""
        with self.lock:
            return self.done.wait_for(lambda: self.in_flight == 0, timeout)

    def outstanding(self) -> int:
        with self.lock:
            return self.in_flight

    def latencies(self, t0: float, t1: float) -> List[float]:
        return [d - s for s, d, ok in self.records if ok and t0 <= d <= t1]

    def failed_in(self, t0: float, t1: float) -> int:
        return sum(1 for _, d, ok in self.records if not ok and t0 <= d <= t1)

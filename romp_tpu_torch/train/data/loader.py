"""Multi-worker prefetching batch loader.

The port's copy of the JAX package's numpy-only
`romp_tpu/train/data/loader.py`, so that the port imports nothing of that
package.

The reference feeds training with torch DataLoaders running `nw` worker
processes (`romp/base.py:126-144`); here batch assembly (sampling, cv2
augmentation, centermap GT generation — all numpy/cv2 host work that
releases the GIL) runs on worker THREADS filling a bounded queue, so the
next batches are being built while the device computes the current step
(the Trainer's pipelined fit() overlaps the device side; this overlaps
the host side).

Threads, not processes: the samplers share the in-memory dataset records
(no pickling/fork cost), and the heavy inner loops (cv2 warpAffine, numpy
stacking, jpeg decode) drop the GIL. On a many-core host, point
`num_workers` at the core count like the reference's `--nw`.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class PrefetchLoader:
    """Wraps a batch-iterator factory with worker threads + a bounded queue.

    make_iterator(seed) -> an infinite iterator of batch dicts. Each worker
    gets a distinct seed, so the union stream is the same family of random
    batches as the single-threaded iterator (cross-worker interleaving is
    nondeterministic; use num_workers=1 for a fully deterministic stream —
    it still prefetches in the background).
    """

    def __init__(self, make_iterator: Callable[[int], Iterator[Dict]],
                 num_workers: int = 2, prefetch: int = 4, seed: int = 0):
        assert num_workers >= 1 and prefetch >= 1
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._threads = []
        for w in range(num_workers):
            t = threading.Thread(target=self._work,
                                 args=(make_iterator, seed + w), daemon=True)
            t.start()
            self._threads.append(t)

    def _work(self, make_iterator, seed: int):
        try:
            for batch in make_iterator(seed):
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.25)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as exc:  # noqa: BLE001 — surfaced to consumer
            self._error = exc
            self._stop.set()

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        while True:
            # already-produced batches are delivered before any error/stop
            try:
                return self._q.get_nowait()
            except queue.Empty:
                pass
            if self._error is not None:
                raise self._error
            if self._stop.is_set():
                raise StopIteration
            try:
                return self._q.get(timeout=0.25)
            except queue.Empty:
                continue

    def close(self):
        """Stop the workers and wait for each to finish the batch it is
        assembling: a worker may run device work (TRACE's frozen backbone
        and RAFT's flow), which must not outlive the run that started it."""
        self._stop.set()
        # drain so blocked workers can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join()

"""Host-side batched data loader with thread prefetch.

Replaces the reference's ``torch.utils.data.DataLoader`` worker-process
pipeline (``models.py:116-157``).  Design:

- host threads only decode + run the *deterministic* per-sample transforms
  (window / standardize / interpolate) so samples reach a common static
  shape;
- the random augmentations move on-device as one fused, vmapped, jitted
  function (:func:`bodyct_dram_emph_subtype.transforms.batch_augment`),
  keeping the host path cheap and the hot loop entirely on the device;
- batches are prefetched ahead of compute so the next host batch overlaps
  with the current device step.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np


def prefetch_to_device(iterator: Iterable, put_fn: Callable, size: int = 2):
    """Double-buffer host batches onto the device: keep ``size`` batches in
    flight so the host→device transfer of batch N+1 overlaps with compute on
    batch N (the role of pinned-memory + overlapped H2D in the reference's
    torch pipeline)."""
    import collections

    queue_: "collections.deque" = collections.deque()
    it = iter(iterator)
    try:
        for _ in range(size):
            queue_.append(put_fn(next(it)))
    except StopIteration:
        pass
    while queue_:
        out = queue_.popleft()
        try:
            queue_.append(put_fn(next(it)))
        except StopIteration:
            pass
        yield out


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack array fields, list the rest (uid strings etc.)."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, (np.ndarray, np.generic)) or hasattr(first, "__array__"):
            out[key] = np.stack([np.asarray(v) for v in vals])
        elif isinstance(first, (int, float, bool, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Iterates ``dataset`` over ``indices`` in batches with thread prefetch."""

    def __init__(self, dataset, indices: Optional[Sequence[int]] = None,
                 batch_size: int = 1, drop_last: bool = False,
                 num_workers: int = 4, prefetch: int = 2,
                 collate: Callable = default_collate):
        self.dataset = dataset
        self.indices = indices
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.collate = collate

    def _index_batches(self) -> List[List[int]]:
        idx = (list(self.indices) if self.indices is not None
               else list(range(len(self.dataset))))
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __len__(self):
        return len(self._index_batches())

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._index_batches()
        if not batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                # pipeline the per-sample fetches, preserve batch order
                futures = [
                    [pool.submit(self.dataset.__getitem__, i) for i in b]
                    for b in batches]
                for fb in futures:
                    if stop.is_set():
                        for f in fb:
                            f.cancel()
                        continue
                    try:
                        q.put(self.collate([f.result() for f in fb]))
                    except Exception as exc:  # surface in consumer
                        q.put(exc)
                        break
            q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

"""Input pipeline: super-batch assembly, background prefetch and the
copy to the card (counterpart of ``adlm_tpu.data.pipeline``).

The training step consumes whole gradient-accumulation windows
(iter_size, micro_bs, H, W, 3), so the loader builds those directly.  A
pool of threads or spawned processes augments the samples, a background
thread keeps the next windows ready (the reference relies on torch
DataLoader workers, reference data_module.py:26-39), and
``device_prefetch`` copies them to the card from pinned memory on a
stream of its own while the step computes.

This module imports numpy only: the process mode's spawned workers
import it, and ``torch`` (with its CUDA state) stays out of them.
``device_prefetch`` imports ``torch`` when it is called.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional, Tuple

import numpy as np

from adlm_tpu_torch.data.dataset import SegmentationDataset


def _zip_leaves(fn, item, spec):
    """``fn(leaf, spec_leaf)`` over the leaves of nested tuples, lists and
    dicts and a ``spec`` of the same nesting (a None spec passes None)."""
    if isinstance(item, (tuple, list)):
        specs = spec if spec is not None else [None] * len(item)
        return type(item)(_zip_leaves(fn, x, s) for x, s in zip(item, specs))
    if isinstance(item, dict):
        return {k: _zip_leaves(fn, v, None if spec is None else spec[k])
                for k, v in item.items()}
    return fn(item, spec)


def device_prefetch(iterable, depth: int = 2, device: Any = "cuda",
                    dtypes: Any = None):
    """Copy the numpy leaves of the next ``depth`` items to ``device``
    while the consumer computes on the current one.

    On the card each leaf is staged in pinned host memory and copied
    with ``non_blocking=True`` on a copy stream of its own, so the copy
    does not wait for the work queued on the consumer's stream (a copy
    from pageable memory does, and stalled the bf16 push by 14-18%,
    PERF.md).  Before an item is yielded, the consumer's current stream
    waits on the item's copy event, and each tensor is marked as used on
    that stream, so that the allocator does not hand its memory to a
    later copy too early.  A pinned buffer is reused only once the event
    of its last copy has completed.

    ``dtypes`` has the nesting of an item and names the torch dtype each
    leaf ships as (None keeps the leaf's own): the cast happens on the
    host, into the pinned buffer, e.g. f32 images into a bf16 buffer
    (``train/pipeline.py::ship_dtypes``).  Non-array leaves (counts,
    metadata) pass through untouched.  ``device`` is the card unless the
    caller passes ``"cpu"``; without a card it raises here, at the call.
    """
    import collections

    import torch

    from adlm_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    pinned: dict = collections.defaultdict(list)   # (shape, dtype) → [[buf, event]]
    q: "collections.deque" = collections.deque()

    def host_tensor(x, dtype):
        t = torch.from_numpy(np.array(x))
        return t if dtype is None else t.to(dtype)

    def stage(x, dtype):
        """The pinned slot [buffer, event of its last copy] that now
        holds ``x`` cast to ``dtype``."""
        src = torch.from_numpy(np.ascontiguousarray(x))
        dtype = dtype or src.dtype
        slots = pinned[(src.shape, dtype)]
        for slot in slots:
            if slot[1] is None or slot[1].query():
                break
        else:
            slot = [torch.empty(src.shape, dtype=dtype, pin_memory=True), None]
            slots.append(slot)
        slot[0].copy_(src)
        return slot

    def put(item):
        if copy_stream is None:
            q.append((_zip_leaves(
                lambda x, dt: host_tensor(x, dt) if isinstance(x, np.ndarray)
                else x, item, dtypes), None))
            return
        used = []

        def upload(x, dt):
            if not isinstance(x, np.ndarray):
                return x
            slot = stage(x, dt)
            used.append(slot)
            with torch.cuda.stream(copy_stream):
                return slot[0].to(dev, non_blocking=True)

        out = _zip_leaves(upload, item, dtypes)
        ev = torch.cuda.Event()
        ev.record(copy_stream)
        for slot in used:
            slot[1] = ev
        q.append((out, ev))

    def items():
        it = iter(iterable)
        for x in it:
            put(x)
            if len(q) >= depth:
                break
        while q:
            out, ev = q.popleft()
            try:
                put(next(it))
            except StopIteration:
                pass
            if ev is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(ev)
                _zip_leaves(lambda t, _: t.record_stream(consumer)
                            if isinstance(t, torch.Tensor) else None, out, None)
            yield out

    return items()


_PROC_DS: Optional[SegmentationDataset] = None
_PROC_SHM = None  # the worker's view of the parent's _ShmRing


class _ShmRing:
    """Preallocated shared-memory sample slots for the process-mode
    loader's RETURN PATH.

    A ProcessPoolExecutor result pickles through a pipe: ~3.2 MB per
    flagship sample, serialized twice and copied through the OS pipe
    buffer (the JAX package measured 41 img/s at ×2 workers against 156
    for threads ×4).  Here the worker writes the augmented (wh, ww, 3)
    f32 window + (wh, ww) i32 label straight into its task's
    preallocated slot and returns only the slot index; the parent copies
    out of the slot.  One slot per sample of a window: the parent drains
    the whole map() before issuing the next window, so slots are never
    reused while in flight.
    """

    def __init__(self, n_slots: int, img_shape, lab_shape):
        from multiprocessing import shared_memory
        self._geometry(n_slots, img_shape, lab_shape)
        self.shm = shared_memory.SharedMemory(
            create=True, size=max(1, n_slots * self.slot_nbytes))
        self.name = self.shm.name

    def _geometry(self, n_slots: int, img_shape, lab_shape) -> None:
        self.img_shape = tuple(img_shape)
        self.lab_shape = tuple(lab_shape)
        self.img_nbytes = int(np.prod(self.img_shape)) * 4  # f32
        self.lab_nbytes = int(np.prod(self.lab_shape)) * 4  # i32
        self.slot_nbytes = self.img_nbytes + self.lab_nbytes
        self.n_slots = n_slots

    @classmethod
    def attach(cls, name: str, n_slots: int, img_shape, lab_shape) -> "_ShmRing":
        """A worker's view of the parent's ring."""
        from multiprocessing import shared_memory
        ring = cls.__new__(cls)
        ring._geometry(n_slots, img_shape, lab_shape)
        ring.shm = shared_memory.SharedMemory(name=name)
        ring.name = name
        return ring

    def views(self, slot: int):
        off = slot * self.slot_nbytes
        img = np.ndarray(self.img_shape, np.float32,
                         buffer=self.shm.buf, offset=off)
        lab = np.ndarray(self.lab_shape, np.int32,
                         buffer=self.shm.buf,
                         offset=off + self.img_nbytes)
        return img, lab

    def close(self, unlink: bool):
        # view lifetimes: callers must not hold views past close()
        self.shm.close()
        if unlink:
            try:
                self.shm.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass


def _proc_worker_init(cfg, split_key: str, data_path: Optional[str],
                      shm_name: str, img_shape, lab_shape, n_slots: int):
    """Build the dataset ONCE per loader process (spawn context: a fork
    would inherit the parent's threads and CUDA state) and attach to the
    parent's shared-memory sample ring."""
    global _PROC_DS, _PROC_SHM
    _PROC_DS = SegmentationDataset(cfg, split_key, data_path=data_path)
    # NOTE: no resource_tracker.unregister here — spawn children
    # inherit the PARENT'S tracker process, so the attach's
    # re-register is a set no-op and the parent's unlink() performs
    # the single unregister; a child-side unregister would race it
    # (observed as tracker KeyError noise at shutdown)
    _PROC_SHM = _ShmRing.attach(shm_name, n_slots, img_shape, lab_shape)


def _proc_worker_get_shm(index: int, seed: int, slot: int):
    """Write the sample into its shared-memory slot and return the slot
    index (or the arrays, if the item does not fit the ring's geometry,
    which windowed train items always do)."""
    img, lab = _PROC_DS.get_train_item(index, seed)
    ring = _PROC_SHM
    if img.shape != ring.img_shape or lab.shape != ring.lab_shape:
        return img, lab  # pragma: no cover — shape drift safety net
    iv, lv = ring.views(slot)
    np.copyto(iv, img)
    np.copyto(lv, lab.astype(np.int32, copy=False))
    return slot


def sample_seed(seed: int, counter: int) -> int:
    """Per-sample augmentation seed: a pure function of the loader seed
    and the global sample counter.  Makes the augmentation stream
    deterministic under any scheduling and exactly replayable from any
    window (a resume stores only the window index)."""
    return (seed + 1) * (1 << 40) + counter


def superbatch_iterator(dataset: SegmentationDataset, iter_size: int,
                        batch_size: int, steps: int,
                        seed: int = 0, n_jobs: int = 1,
                        start_window: int = 0, mode: str = "thread"
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields windows ``start_window .. steps-1`` of
    (iter_size, batch_size, H, W, 3) f32 / (iter_size, batch_size, H, W)
    int32, sampling the dataset cyclically in shuffled epochs.
    ``n_jobs`` > 1 loads samples through a pool, the analogue of the
    reference's DataLoader workers (reference data_module.py:26-39):

    * ``mode="thread"``: a thread pool; the C augment releases the
      interpreter lock, the Python-side np.load/stack work does not.
    * ``mode="process"``: spawn-context worker processes, each with its
      own dataset and C library, returning samples through a
      shared-memory ring (``_ShmRing``).

    The streams are the JAX package's, verbatim: the epoch permutations
    come from ``np.random.RandomState(seed)`` and each sample's draws
    from ``random.Random(sample_seed(seed, counter))``.  So every mode
    yields the same windows, bit for bit, and ``start_window > 0``
    reproduces EXACTLY the windows a fresh run would have produced, by
    fast-forwarding the index stream without touching the data."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(dataset))
    pos = 0
    per_window = iter_size * batch_size
    counter = 0

    def next_index() -> int:
        nonlocal pos, order, counter
        if pos >= len(order):
            order = rng.permutation(len(dataset))
            pos = 0
        i = int(order[pos])
        pos += 1
        counter += 1
        return i

    # fast-forward past completed windows (index draws only, no IO)
    for _ in range(start_window * per_window):
        next_index()

    pool = None
    ring = None
    if n_jobs > 1 and mode == "process":
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        # shared-memory return path: one slot per window sample; the
        # worker ships a slot INDEX instead of a ~3.2 MB pickle
        wh, ww = dataset.cfg.window_size
        ring = _ShmRing(per_window, (wh, ww, 3), (wh, ww))
        pool = ProcessPoolExecutor(
            max_workers=n_jobs,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_proc_worker_init,
            initargs=(dataset.cfg, dataset.split_key, dataset.data_path,
                      ring.name, ring.img_shape, ring.lab_shape,
                      ring.n_slots))
        get_items = lambda idxs, seeds: list(
            pool.map(_proc_worker_get_shm, idxs, seeds,
                     range(len(idxs))))
    elif n_jobs > 1:
        pool = ThreadPoolExecutor(max_workers=n_jobs)
        get_items = lambda idxs, seeds: list(
            pool.map(dataset.get_train_item, idxs, seeds))
    else:
        get_items = lambda idxs, seeds: [
            dataset.get_train_item(i, s) for i, s in zip(idxs, seeds)]
    try:
        for _ in range(start_window, steps):
            base = counter
            idxs = [next_index() for _ in range(per_window)]
            seeds = [sample_seed(seed, base + j)
                     for j in range(per_window)]
            items = get_items(idxs, seeds)
            if ring is not None:
                # the map() is drained, so every slot is quiescent: one
                # copy per sample out of its slot; slots are reused next
                # window
                wh, ww = ring.img_shape[:2]
                img_arr = np.empty((per_window, wh, ww, 3), np.float32)
                lab_arr = np.empty((per_window, wh, ww), np.int32)
                for j, it in enumerate(items):
                    if isinstance(it, tuple):  # pragma: no cover
                        img_arr[j], lab_arr[j] = it[0], it[1]
                    else:
                        iv, lv = ring.views(it)
                        img_arr[j] = iv
                        lab_arr[j] = lv
                yield (img_arr.reshape(iter_size, batch_size, wh, ww, 3),
                       lab_arr.reshape(iter_size, batch_size, wh, ww))
                continue
            images = [im for im, _ in items]
            labels = [lb for _, lb in items]
            h, w = images[0].shape[:2]
            img_arr = np.stack(images).reshape(iter_size, batch_size,
                                               h, w, 3)
            lab_arr = np.stack(labels).reshape(iter_size, batch_size, h, w)
            yield img_arr, lab_arr
    finally:
        if pool is not None:
            # wait: a spawned worker still starting attaches to the ring in
            # its initializer, so the ring is unlinked only once every
            # worker has exited (no task is pending here: each window
            # drains its map() before it is yielded)
            pool.shutdown(wait=True, cancel_futures=True)
        if ring is not None:
            ring.close(unlink=True)


class BatchLoader:
    """Wraps an iterator with a background prefetch thread.

    Call :meth:`close` (or break out of iteration and let the caller's
    ``finally`` close it) to stop the worker; otherwise an abandoned
    loader pins its prefetched batches in memory behind a blocked
    ``q.put`` for the life of the process.
    """

    def __init__(self, it: Iterator, prefetch: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._done = object()
        self._stop = threading.Event()
        self._it = it

        def put_retry(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in it:
                    if not put_retry(item):
                        return
            finally:
                # the sentinel must use the same retry loop: a
                # put_nowait on a full queue would silently drop it and
                # hang the consumer after it drains the queue
                put_retry(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the prefetch worker and release the wrapped iterator."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        close_it = getattr(self._it, "close", None)
        if close_it is not None:
            close_it()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                return
            yield item

"""Batched, prefetching host data loader (unite_tpu/data/loader.py).

The reference's torch DataLoader(num_workers=10, persistent_workers=True)
(run_stage1.py:676-692) as the JAX package re-expressed it: a worker-pool
loader with a bounded prefetch window and deterministic per-epoch ordering
from a ShardedSampler, so the port's batches equal the JAX package's
bitwise in the same order.

Two worker modes:

* ``"thread"`` (default): decode + PIL augmentation release the GIL in
  native code, so threads suffice where the pipeline is IO/native-bound,
  and they share the dataset object (no pickling, no fork).
* ``"process"``: forked worker processes for hosts where the pure-Python
  parts of __getitem__ would serialize on the GIL. Workers are forked per
  epoch AFTER set_epoch, so the per-(seed, epoch, index) RNG derivation is
  inherited and batches are bitwise equal to thread mode. Each worker resets
  SIGTERM and SIGINT to their defaults (``_init_worker``).

Also provides ``to_device`` (pinned host memory, ``non_blocking`` copies)
and ``device_prefetch``, an iterator wrapper that keeps N batches in flight
so the host-to-device copy overlaps compute.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np

# fork-inherited worker state: (dataset, collate_fn). Bound per-pool via
# the executor's initializer/initargs: under the fork start method initargs
# are inherited by reference (never pickled), and capturing them at pool
# construction keeps two concurrently-forking loaders from serving each
# other's dataset (a shared parent global would race).
_WORKER_STATE = None


def _init_worker(dataset, collate_fn):
    global _WORKER_STATE
    _WORKER_STATE = (dataset, collate_fn)
    # Forked workers inherit the parent's signal handlers. If the parent
    # installed a catching SIGTERM handler (PreemptionGuard does), the
    # executor's p.terminate() is swallowed and pool shutdown joins a
    # worker that never exits — a hard deadlock observed when an entry
    # main() ran earlier in the same process. Loader workers must die on
    # terminate; preemption policy belongs to the parent alone.
    import signal

    try:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.signal(signal.SIGINT, signal.SIG_DFL)
    except ValueError:  # not the main thread (never the case post-fork)
        pass


def _load_batch_in_worker(batch_idx: Sequence[int]):
    dataset, collate_fn = _WORKER_STATE
    return collate_fn([dataset[i] for i in batch_idx])


def default_collate(items: List):
    """Stack tuple/list items leaf-wise into numpy batches (utils.py:854-898
    multiple_samples_collate flattens num_sample lists — handled here too)."""
    if isinstance(items[0], (list,)) and items and isinstance(items[0][0], tuple):
        # num_sample>1: each item is a list of tuples -> flatten
        items = [x for sub in items for x in sub]
    first = items[0]
    if isinstance(first, tuple):
        return tuple(default_collate([it[i] for it in items])
                     for i in range(len(first)))
    if isinstance(first, np.ndarray):
        return np.stack(items)
    if isinstance(first, (int, np.integer)):
        return np.asarray(items, np.int32)
    if isinstance(first, float):
        return np.asarray(items, np.float32)
    return list(items)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler: Optional[Iterable[int]] = None,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        prefetch_batches: int = 4,
        collate_fn: Callable = default_collate,
        seed: int = 0,
        worker_mode: str = "thread",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.collate_fn = collate_fn
        self.seed = seed
        self.epoch = 0
        self._skip_batches = 0
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r} "
                             "(expected 'thread' or 'process')")
        if worker_mode == "process" and (
                "fork" not in multiprocessing.get_all_start_methods()):
            # process workers rely on fork inheritance (no dataset pickling)
            print("DataLoader: fork unavailable; falling back to threads")
            worker_mode = "thread"
        self.worker_mode = worker_mode

    def skip_next_batches(self, n: int) -> None:
        """Drop the first ``n`` batches of the NEXT iteration (index-level —
        no data is decoded for skipped batches). Consumed once; used for
        exact mid-epoch resume after preemption and for fast-forwarding
        cycled streams (the per-epoch batch order is deterministic given
        the sampler's epoch, so skipping == having already consumed)."""
        self._skip_batches = int(n)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            # advances the dataset's per-(seed, epoch, index) RNG derivation
            self.dataset.set_epoch(epoch)

    def _indices(self) -> List[int]:
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        indices = self._indices()
        batches = [
            indices[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self._skip_batches:
            batches = batches[self._skip_batches:]
            self._skip_batches = 0
        if not batches:
            return
        if self.worker_mode == "process":
            yield from self._iter_process(batches)
            return

        pool = ThreadPoolExecutor(self.num_workers)
        # window caps in-flight batches AND decode concurrency (each
        # task decodes one whole batch): must cover num_workers or
        # excess pool threads sit idle (same fix as _iter_process)
        window = max(self.prefetch_batches, self.num_workers)

        def load_batch(batch_idx: Sequence[int]):
            return self.collate_fn([self.dataset[i] for i in batch_idx])

        # mirror _iter_process's shutdown split: clean exhaustion waits;
        # abandonment (step failure, mid-epoch preemption closing the
        # generator) must NOT block on every in-flight batch decode — a
        # preemption deadline can't afford joining `window` decodes
        try:
            futures = [pool.submit(load_batch, b) for b in batches[:window]]
            next_submit = window
            for i in range(len(batches)):
                yield futures[i % window].result()
                if next_submit < len(batches):
                    futures[next_submit % window] = pool.submit(
                        load_batch, batches[next_submit]
                    )
                    next_submit += 1
        except BaseException:
            pool.shutdown(wait=False, cancel_futures=True)
            raise
        else:
            pool.shutdown(wait=True)

    def _iter_process(self, batches: List[List[int]]) -> Iterator:
        # fork a fresh pool per iteration (≈ per epoch): children inherit
        # the dataset AND its current epoch (set_epoch ran before __iter__),
        # so per-(seed, epoch, index) RNG matches thread mode bitwise. Fork
        # is copy-on-write — per-epoch pool startup is milliseconds.
        # Caveat: under device_prefetch the fork happens on the producer
        # thread of a multi-threaded process (same stance as torch's
        # fork-based DataLoader); workers only run dataset/collate code,
        # which must not depend on parent thread state.
        # ProcessPoolExecutor, NOT multiprocessing.Pool: Pool transparently
        # replaces a crashed worker but never completes its in-flight task,
        # so .get() on that AsyncResult blocks forever — a segfaulting/OOM-
        # killed worker would hang training silently. PPE marks every
        # pending future BrokenProcessPool instead, surfacing the failure
        # like thread mode does. Fork-context initargs are still inherited
        # by reference (never pickled).
        ctx = multiprocessing.get_context("fork")
        window = max(self.prefetch_batches, self.num_workers)
        pool = ProcessPoolExecutor(
            self.num_workers, mp_context=ctx, initializer=_init_worker,
            initargs=(self.dataset, self.collate_fn))
        # NOT a `with` block: on the error path (worker died / task raised)
        # a blocking shutdown(wait=True) can deadlock joining the broken
        # pool's machinery (observed: BrokenProcessPool propagating through
        # __exit__ wedged in process.py shutdown on a loaded host). Clean
        # exhaustion still waits; errors shut down without waiting and
        # cancel the queue.
        try:
            futures = [pool.submit(_load_batch_in_worker, b)
                       for b in batches[:window]]
            next_submit = window
            for i in range(len(batches)):
                yield futures[i % window].result()
                if next_submit < len(batches):
                    futures[next_submit % window] = pool.submit(
                        _load_batch_in_worker, batches[next_submit]
                    )
                    next_submit += 1
        except BaseException:
            pool.shutdown(wait=False, cancel_futures=True)
            raise
        else:
            pool.shutdown(wait=True)


def echo_batches(it: Iterable, k: int, skip_echoes: int = 0) -> Iterator:
    """Batch-level data echoing (Choi et al., arXiv:1907.05550): yield each
    batch ``k`` times so an input-bound host can feed the accelerator at
    line rate. Entries apply this AFTER ``to_device``, so the repeats are
    device-resident: echoed steps cost no host decode and no H2D bytes. The
    step's random draws still advance per step (the generator is seeded
    from the step counter), so drop path differs across echoes of the same
    batch.

    ``skip_echoes``: echoes of the FIRST batch already consumed by a
    preempted run (entries resume with ``loader.skip_next_batches(skip//k)``
    host batches plus ``skip % k`` echoes) — keeps mid-epoch resume replay
    exact under echoing."""
    if k <= 1 and not skip_echoes:
        yield from it
        return
    for b in it:
        for _ in range(k):
            if skip_echoes:
                skip_echoes -= 1
                continue
            yield b


def cycle(loader: DataLoader, skip_batches: int = 0) -> Iterator:
    """Infinite re-iteration (run_stage1.py:313-321 target-stream cycling).
    Bumps the epoch on wrap so shuffles differ (the reference reuses the
    same epoch-0 order every epoch — deliberate improvement).

    ``skip_batches``: total batches already consumed by a previous run —
    fast-forwards the stream (epoch wraps + index-level within-epoch skip,
    no data decoded) so a resumed run sees exactly the batches an
    uninterrupted run would. Entries pass ``steps_already_run`` here; the
    reference sidesteps this by recreating its target iterator every epoch
    with a never-advanced sampler epoch (run_stage1.py:313-321)."""
    if len(loader) == 0:
        # e.g. a per-process target shard smaller than batch_size with
        # drop_last: without this the resume path divides by zero and the
        # normal path spins set_epoch forever inside the prefetch producer
        raise ValueError(
            "cycle() needs a loader that yields at least one batch per "
            "epoch (dataset shard smaller than batch_size with drop_last?)")
    epoch = loader.epoch
    if skip_batches:
        n = len(loader)
        epoch += skip_batches // n
        loader.set_epoch(epoch)
        loader.skip_next_batches(skip_batches % n)
    while True:
        for batch in loader:
            yield batch
        epoch += 1
        loader.set_epoch(epoch)


def device_prefetch(iterator: Iterable, put: Callable, depth: int = 2):
    """Keep ``depth`` device batches in flight (H2D overlaps compute).

    ``put`` maps a host batch to device tensors (e.g. ``to_device``).

    The producer polls a stop flag while the queue is full: if the consumer
    abandons the generator (preemption break, step exception, fixed-step
    bench loop), the generator's ``finally`` sets the flag and the producer
    exits within the poll interval instead of blocking in q.put() forever —
    which would leak the thread plus up to depth+window decoded/device
    batches per abandoned epoch. The ``finally`` then joins the producer,
    so that no ``put`` (a device copy, stage 3's zero-shot teacher) is
    still running once the generator is closed: that takes at most the
    batch in hand."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    error: list = []

    def _offer(obj) -> bool:
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not _offer(put(item)):
                    return  # consumer gone
        except BaseException as e:  # propagate to the consumer
            error.append(e)
        _offer(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                break
            yield item
    finally:
        stop.set()
        t.join()


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device``: through pinned host memory with
    ``non_blocking`` copies on a CUDA device (the copy overlaps the step
    running on the card), as they are on the CPU."""
    import torch

    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out

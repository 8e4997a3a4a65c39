"""Batched, prefetching, host-sharded data loader, the port of
``ncnet_tpu/data/loader.py`` (``DataLoader``, ``default_collate``) as it is.

Samples are numpy arrays destined for one host-to-device copy per batch,
multi-host runs want each host to own a disjoint shard of every epoch, and
determinism comes from explicit seeds, not process-fork timing.

Design:
  * thread-pool sample decoding (PIL/numpy release the GIL for the heavy
    parts; worker *processes* buy nothing for this workload),
  * double-buffered background prefetch of collated batches so host decode
    overlaps device compute,
  * epoch-keyed shuffling via ``np.random.Generator(seed, epoch)`` — the
    determinism the reference's per-worker seeding was added for, without
    vendored machinery,
  * ``num_shards``/``shard_index`` slicing after the shuffle for multi-host
    (per-host input sharding; pairs with the mesh 'data' axis).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Set

import numpy as np
import torch

from ncnet_tpu_torch.data.datasets import SampleDecodeError


def default_collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of dict samples into a dict of batched arrays."""
    out: Dict[str, np.ndarray] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(first, (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:  # strings etc. pass through as lists (reference collate_custom)
            out[key] = vals
    return out


def stage_array(a, device: torch.device) -> torch.Tensor:
    """A host batch array as a tensor on ``device``; on CUDA from pinned
    memory without waiting, so the copy queues behind the card's work (the
    training and eval loops' staging)."""
    t = a if torch.is_tensor(a) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(a)))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DataLoader:
    """Iterable over collated batches of a map-style dataset.

    Args:
      dataset: object with ``__len__`` and ``__getitem__`` → dict of arrays.
      batch_size: global per-host batch size.
      shuffle: epoch-keyed deterministic shuffle.
      num_workers: decode threads (0 ⇒ synchronous decode, no prefetch).
      drop_last: drop the trailing partial batch.
      num_shards / shard_index: this host's share of the (shuffled) epoch.
      seed: base seed; the epoch index is mixed in per epoch.
      on_decode_error: 'raise' (default) propagates a dataset
        :class:`SampleDecodeError`; 'quarantine' logs + records the bad
        path (``self.quarantined``) and substitutes the next healthy
        dataset sample, so one corrupt file costs the epoch at most that
        sample instead of the whole run.  Substitution is
        index-deterministic (idx+1, idx+2, ... mod len), so a given corrupt
        file always maps to the same replacement.

    Mid-epoch resume: ``set_epoch(epoch, start_batch=B)`` skips the first
    ``B`` batches of the epoch *before* decode (no wasted work) while
    keeping the epoch-keyed shuffle, so a resumed run sees exactly the
    batches the crashed run never consumed.  ``len()`` still reports the
    full epoch; consumers read ``start_batch`` back for global indexing.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 0,
        drop_last: bool = False,
        num_shards: int = 1,
        shard_index: int = 0,
        seed: int = 1,
        prefetch_batches: int = 2,
        on_decode_error: str = "raise",
    ):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        if on_decode_error not in ("raise", "quarantine"):
            raise ValueError(
                f"on_decode_error {on_decode_error!r}: use 'raise' or "
                "'quarantine'"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.on_decode_error = on_decode_error
        self.quarantined: Set[str] = set()   # bad image paths, for reporting
        self._bad_indices: Set[int] = set()  # dataset indices to skip over
        # guards quarantine-state WRITES and snapshot reads: _quarantine
        # runs on prefetch worker threads while eval consumers snapshot
        # bad_indices on the main thread (membership tests stay lock-free —
        # atomic under the GIL)
        self._quarantine_lock = threading.Lock()
        self.epoch = 0  # bump (or pass to set_epoch) to reshuffle
        self.start_batch = 0

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        self.epoch = epoch
        self.start_batch = start_batch

    @property
    def bad_indices(self) -> frozenset:
        """Dataset indices whose OWN samples failed decode (and were
        substituted under the quarantine policy).  Eval consumers key their
        invalid-scoring on this, not on ``quarantined`` paths: an image can
        be shared across samples and fail transiently for one of them —
        path-level matching would wrongly invalidate the healthy ones.
        Snapshot under the quarantine lock: prefetch workers mutate the set
        concurrently, and an unguarded frozenset() can raise mid-iteration."""
        with self._quarantine_lock:
            return frozenset(self._bad_indices)

    def _shard_len(self) -> int:
        n = len(self.dataset)
        return n // self.num_shards if self.num_shards > 1 else n

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng([self.seed, self.epoch])
            rng.shuffle(idx)
        if self.num_shards > 1:
            # even, disjoint shards; trailing remainder dropped so every host
            # sees the same number of batches (collective-friendly)
            per = len(idx) // self.num_shards
            idx = idx[self.shard_index * per : (self.shard_index + 1) * per]
        return idx

    def __len__(self) -> int:
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[np.ndarray]:
        idx = self._epoch_indices()
        for bi, start in enumerate(range(0, len(idx), self.batch_size)):
            chunk = idx[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            if bi < self.start_batch:
                continue  # mid-epoch resume: already consumed before a crash
            yield chunk

    def _quarantine(self, err: SampleDecodeError, idx: int) -> None:
        with self._quarantine_lock:
            self._bad_indices.add(idx)
            fresh = err.path not in self.quarantined
            self.quarantined.add(err.path)
        if fresh:
            from ncnet_tpu_torch.observability import events as obs_events
            from ncnet_tpu_torch.observability import get_logger

            get_logger("data").warning(
                f"[fault-tolerance] quarantined undecodable sample "
                f"{err.path!r}: {err}", kind="decode")
            obs_events.emit("quarantine", unit=str(err.path), kind="decode",
                            scope="sample", error=str(err)[:300])

    # fresh (not previously known-bad) decode failures tolerated within ONE
    # substitution scan before declaring the failure systemic: large enough
    # to ride out a cluster of corrupt files, small enough that a wrong
    # --dataset_image_path fails in seconds, not after scanning every sample
    _MAX_FRESH_FAILURES = 8

    def _fetch(self, i: int) -> Dict[str, np.ndarray]:
        i = int(i)
        try:
            if i not in self._bad_indices:
                return self.dataset[i]
            err = None  # known-bad: go straight to substitution
        except SampleDecodeError as e:
            if self.on_decode_error != "quarantine":
                raise
            self._quarantine(e, i)
            err = e
        n = len(self.dataset)
        fresh_failures = 1 if err is not None else 0
        for k in range(1, n):
            j = (i + k) % n
            if j in self._bad_indices:
                continue
            try:
                return self.dataset[j]
            except SampleDecodeError as e:
                self._quarantine(e, j)
                err = e
                fresh_failures += 1
                if fresh_failures >= self._MAX_FRESH_FAILURES:
                    raise SampleDecodeError(
                        f"<{fresh_failures} consecutive samples>", e
                    ) from e  # systemic (bad image root?), not one bad file
        raise SampleDecodeError(
            f"<no decodable sample left: {len(self._bad_indices)}/{n} "
            "quarantined>", err
        )

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        if self.num_workers <= 0:
            for chunk in self._batches():
                yield default_collate([self._fetch(i) for i in chunk])
            return
        yield from self._prefetch_iter()

    def _prefetch_iter(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        sentinel = object()
        stop = threading.Event()
        err: List[BaseException] = []

        def put_interruptible(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for chunk in self._batches():
                        if stop.is_set():
                            return
                        samples = list(
                            pool.map(self._fetch, [int(i) for i in chunk])
                        )
                        if not put_interruptible(default_collate(samples)):
                            return
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                put_interruptible(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # abandoned early (break / exception in consumer): unblock and
            # stop the producer instead of leaking it on the bounded queue
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10)
        if err:
            raise err[0]

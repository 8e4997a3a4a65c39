"""Crash-safe, content-addressed persistent feature store, the port of
``ncnet_tpu/store/feature_store.py``.

InLoc-style localization serves queries against a FIXED database of panos,
and without a store every query pays two full backbone extractions
because nothing persists between calls.  This module is
the database side of that workload made durable: backbone features are
computed once, committed to disk, and verified on every read — turning each
query into ONE extraction (its own) plus cached matching, the classic
millions-of-users-one-index production shape.

Persistent state is also the first place this stack could start returning
*silently wrong* answers — a torn write, a flipped bit, features computed
under superseded weights — so the store is built robustness-first around
one invariant: **a query NEVER fails because of the store and NEVER uses
unverified bytes.**  The mechanisms:

  * **Content-addressed keys** — an entry is keyed by the sha256 digest of
    the raw database image bytes (:func:`content_digest`), under a
    **backbone fingerprint** directory (:func:`backbone_fingerprint` =
    weights digest + ``image_size`` + ``k_size`` + dtype + the program
    that extracted the features, ROADMAP D8).  Features from
    different weights / preprocessing can never collide; a re-trained
    checkpoint simply addresses a different generation.
  * **Verified reads** — every entry carries a sha256 checksum over its raw
    array bytes in a JSON header line.  A mismatch (or an unparseable
    header, foreign fingerprint, newer schema) QUARANTINES the entry file
    into ``<root>/quarantine/`` (atomic rename — the evidence is preserved
    for the postmortem, the poisoned bytes can never be served) and reads
    as a miss: the caller transparently recomputes and rewrites.
  * **Two-phase atomic commits** — entries land via
    ``utils/io.atomic_write_bytes`` (pid-suffixed temp + ``os.replace``,
    fsync file + parent dir: the opt-in DURABLE commit), with the
    ``faults.store_commit_kill_hook`` seam between payload write and
    rename: SIGKILL mid-commit leaves a temp carcass and NO visible entry.
  * **Degradation ladder** — any I/O failure (disk full, permissions, a
    dying disk) fails OPEN: reads report a miss, writes become no-ops, the
    store transitions to DEGRADED (a ``store_health`` event + the health
    section consumers surface on ``/healthz``), and the first later
    successful operation transitions it back to OK — the DEGRADED →
    recovered timeline the chaos suite asserts from the event log.
  * **Superseded-generation GC** — :meth:`FeatureStore.gc_superseded`
    removes sibling fingerprint directories whose WEIGHTS digest differs
    from the current one (new weights = a dead generation); sibling dirs
    with the same weights but a different size/k/dtype belong to another
    live consumer (e.g. the serving engine's bucket ladder) and are kept.
  * **LRU eviction with a journal** — ``budget_bytes`` bounds the
    generation's footprint; the least-recently-used entry is evicted
    first, with access order persisted in an append-only, torn-tail-
    tolerant ``journal.jsonl`` (put/evict records fsynced under the
    durable contract, touch records best-effort) so LRU order survives
    restarts.  The journal is compacted on open when it dwarfs the entry
    count.

Telemetry: hit/miss/corrupt/evict/degraded counters ride the health dict
(rendered as ``ncnet_store_*`` families on the serving ``/metrics`` plane
and flushed as one ``store_stats`` event by :meth:`flush_stats`);
transitions and quarantines are events (``store_health``, ``store_corrupt``,
``store_evict``, ``store_gc``), replayable via ``run_report --store``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ncnet_tpu_torch.observability import events as obs_events
from ncnet_tpu_torch.observability import get_logger
from ncnet_tpu_torch.utils import faults
from ncnet_tpu_torch.utils.io import atomic_write_bytes, fsync_dir

log = get_logger("store")

SCHEMA_VERSION = 1
_MAGIC = "ncnet-feature-store"
_ENTRY_SUFFIX = ".feat"
# a header line is a few hundred bytes; a "header" that exceeds this is a
# corrupt file, not a header (bounds the read on a garbage first line)
_MAX_HEADER_BYTES = 4096
# commit carcasses (*.feat.tmp.<pid>) older than this are swept on open: a
# LIVE writer's temp lives for seconds, so age is a safe ownership test
_TMP_SWEEP_AGE_S = 600.0

STORE_OK = "OK"
STORE_DEGRADED = "DEGRADED"


def content_digest(array: np.ndarray) -> str:
    """Content address of one array (dtype + shape + raw bytes, sha256),
    the JAX package's digest bit for bit.  For the localization database
    it is computed over the raw decoded uint8 image, so the same pano file
    always resolves to the same entry whichever query's shortlist named
    it."""
    a = np.ascontiguousarray(array)
    h = hashlib.sha256()
    h.update(str(a.dtype.str).encode())
    h.update(str(tuple(a.shape)).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:32]


def weights_digest(params) -> str:
    """Digest of the backbone weights, the generation identity: every trunk
    leaf's dtype, shape and bytes in the JAX package's leaf order and layout
    (``models/checkpoint._jax_leaves``), so the same weights give the JAX
    package's digest.  NC-filter params are left out: database features are
    a function of the trunk alone."""
    from ncnet_tpu_torch.models.checkpoint import _jax_array, _jax_leaves

    tree = params.get("backbone", params) if isinstance(params, dict) \
        else params
    h = hashlib.sha256()
    for leaf, _, key in _jax_leaves(tree, in_trunk=True):
        dtype, a = _jax_array(leaf, True, key)
        h.update(dtype.encode())
        h.update(str(tuple(a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _program_token(device) -> str:
    """The name of the program that extracts an entry's features: the
    port (``torch``) on a device type.  The port's trunk does not compute
    the JAX package's bytes, nor the card the CPU's, so each is a
    generation of its own (ROADMAP D8)."""
    import torch

    return f"torch.{torch.device(device).type}"


def backbone_fingerprint(params, *, image_size, k_size: int,
                         dtype: str, device="cuda") -> str:
    """The fingerprint an entry is valid under:
    ``<weights digest>-s<image_size>-k<k_size>-<dtype>-<program>``.

    The JAX package's fingerprint is the same without the last segment:
    the weights digest leads in both, so ``gc_superseded`` keeps the
    other package's generation of the same weights, while a directory that
    one package wrote is a miss for the other (ROADMAP D8).
    ``image_size`` may be an int (the InLoc resize target) or a string
    token (the serving engine's path, where the bucket shape lives in the
    content digest).  Everything that changes the bytes an entry holds is
    in here: a fingerprint mismatch is a miss, never a wrong answer."""
    return (f"{weights_digest(params)}-s{image_size}-k{int(k_size)}-{dtype}"
            f"-{_program_token(device)}")


def coarse_fingerprint(base_fingerprint: str, factor: int) -> str:
    """The retrieval tier's coarse-volume generation:
    ``<base fingerprint>-c<factor>`` — a DISTINCT store generation from
    the dense features it was pooled from (a coarse entry must never
    answer a dense read or vice versa), but sharing the leading weights
    segment, so :meth:`FeatureStore.gc_superseded`'s keep-same-weights-
    siblings rule protects dense and coarse generations of the same
    weights together.  ``base_fingerprint`` is a
    :func:`backbone_fingerprint` for backbone-pooled volumes, or a
    synthetic model-free token (e.g. ``raw-s16-k0-f32``) for the
    ``raw`` extractor — the index writer and every reader derive it the same
    way, so a mismatch is a MISS, never a wrong shortlist."""
    return f"{base_fingerprint}-c{int(factor)}"


def _weights_segment(fingerprint: str) -> str:
    return fingerprint.split("-", 1)[0]


class FeatureStore:
    """One generation of the persistent feature store (see module
    docstring).  Thread-safe: the serving engine resolves entries from
    replica fetcher threads concurrently.

    ``resolve(digest, compute)`` is the API consumers should use — it IS
    the degradation ladder in one place: verified hit → cached bytes;
    miss / corruption / I/O failure → ``compute()`` + best-effort rewrite.
    ``compute`` failures propagate (they are the caller's device errors,
    owned by its retry/quarantine isolation, not the store's)."""

    def __init__(self, root: str, fingerprint: str, *,
                 budget_bytes: int = 0, durable: bool = True,
                 scope: str = "store"):
        self.root = root
        self.fingerprint = fingerprint
        self.budget_bytes = int(budget_bytes)
        self.durable = bool(durable)
        self.scope = scope
        self.state = STORE_OK
        self.state_reason: Optional[str] = None
        self._lock = threading.RLock()
        # digest -> file size in bytes, in LRU order (oldest first)
        self._lru: "OrderedDict[str, int]" = OrderedDict()
        self._bytes = 0
        self._journal_f = None
        self._journal_appends = 0
        self._closed = False
        # digests with a commit in flight: the budget enforcer must not
        # pick one as its eviction victim (deleting a just-recommitted
        # entry's fresh file)
        self._inflight_puts: set = set()
        # monotone failure counter: an operation may only claim recovery
        # (_note_ok) if NOTHING failed while it ran — without this, a
        # journal/evict failure inside get()/put() would be cleared by the
        # same call's trailing recovery check and never surface in health
        self._fail_seq = 0
        self.counters: Dict[str, int] = {
            "hits": 0, "misses": 0, "puts": 0, "corrupt": 0,
            "evictions": 0, "degraded_ops": 0, "gc_entries": 0,
        }
        try:
            os.makedirs(self._gen_dir(), exist_ok=True)
            self._open_journal()
            self._reconcile()
        except OSError as e:
            self._fail("open", e)
        obs_events.emit("store_open", scope=self.scope, root=self.root,
                        fingerprint=self.fingerprint,
                        entries=len(self._lru), bytes=self._bytes,
                        budget_bytes=self.budget_bytes, state=self.state)

    # -- paths --------------------------------------------------------------

    def _gen_dir(self) -> str:
        return os.path.join(self.root, self.fingerprint)

    def _entry_path(self, digest: str) -> str:
        return os.path.join(self._gen_dir(), digest + _ENTRY_SUFFIX)

    def _journal_path(self) -> str:
        return os.path.join(self._gen_dir(), "journal.jsonl")

    def _quarantine_dir(self) -> str:
        return os.path.join(self.root, "quarantine")

    # -- open-time reconciliation ------------------------------------------

    def _open_journal(self) -> None:
        self._journal_f = open(self._journal_path(), "a")

    def _replay_journal(self) -> "OrderedDict[str, bool]":
        """Journal-recorded access order: ``digest -> True`` for digests
        the journal last saw alive, oldest access first.  Torn tails and
        foreign lines are skipped — records are independent."""
        order: "OrderedDict[str, bool]" = OrderedDict()
        try:
            with open(self._journal_path(), "rb") as f:
                raw = f.read()
        except OSError:
            return order
        for line in raw.split(b"\n"):
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail / foreign line
            if not isinstance(rec, dict):
                continue
            op, digest = rec.get("op"), rec.get("digest")
            if not isinstance(digest, str):
                continue
            if op in ("put", "touch"):
                order.pop(digest, None)
                order[digest] = True
            elif op in ("evict", "quarantine"):
                order.pop(digest, None)
        return order

    def _reconcile(self) -> None:
        """Files on disk are the truth for existence; the journal supplies
        LRU order.  Entries the journal never saw (or whose records were
        lost) fall back to mtime order and are appended oldest-first.
        Stale commit carcasses (``*.feat.tmp.<pid>`` left by writers
        killed mid-commit) are swept once old enough that no live writer
        can still own them — crash loops must not accumulate invisible
        disk usage the budget never counts."""
        now = time.time()
        on_disk: Dict[str, Tuple[int, float]] = {}
        for name in os.listdir(self._gen_dir()):
            path = os.path.join(self._gen_dir(), name)
            if _ENTRY_SUFFIX + ".tmp." in name:
                try:
                    if now - os.stat(path).st_mtime > _TMP_SWEEP_AGE_S:
                        os.remove(path)
                except OSError:
                    pass
                continue
            if not name.endswith(_ENTRY_SUFFIX):
                continue
            try:
                st = os.stat(path)
            except OSError:
                continue
            on_disk[name[: -len(_ENTRY_SUFFIX)]] = (st.st_size, st.st_mtime)
        journal_order = self._replay_journal()
        self._lru.clear()
        self._bytes = 0
        unknown = sorted(
            (d for d in on_disk if d not in journal_order),
            key=lambda d: on_disk[d][1])
        for digest in [d for d in journal_order if d in on_disk] + unknown:
            size = on_disk[digest][0]
            self._lru[digest] = size
            self._bytes += size
        try:
            with open(self._journal_path(), "rb") as jf:
                self._journal_appends = sum(1 for _ in jf)
        except OSError:
            self._journal_appends = len(journal_order)
        if self._journal_needs_compaction():
            self._compact_journal_locked()

    def _journal_needs_compaction(self) -> bool:
        return (self._journal_appends > 64
                and self._journal_appends > 4 * max(1, len(self._lru)))

    def _compact_journal_locked(self) -> None:
        """Rewrite the journal as one put-record per live entry in LRU
        order (touch records accumulate one per hit; a long-lived warm
        process would otherwise grow the file without bound).  Multi-
        writer caveat, a documented tradeoff: a concurrent process
        sharing this store root keeps appending to the REPLACED inode, so
        its records until its next reopen are lost — acceptable because
        the journal is ADVISORY: entries are discovered from the
        directory and verified per read, so a lost record can only
        degrade eviction ORDER (mtime fallback on the next open), never
        correctness."""
        body = "".join(
            json.dumps({"op": "put", "digest": d, "bytes": s,
                        "t": round(time.time(), 3)}) + "\n"
            for d, s in self._lru.items())
        if self._journal_f is not None:
            self._journal_f.close()
            # None-out BEFORE the rewrite: if it fails, a closed-but-
            # non-None handle would make every later append raise into
            # _fail and pin the store DEGRADED forever — None instead
            # routes appends through the lazy reopen in _journal
            self._journal_f = None
        try:
            atomic_write_bytes(self._journal_path(), body.encode(),
                               durable=self.durable)
        finally:
            try:
                self._open_journal()
            except OSError:
                self._journal_f = None  # lazily reopened by _journal
        self._journal_appends = len(self._lru)

    # -- degradation state machine -----------------------------------------

    def _fail(self, op: str, exc: BaseException) -> None:
        with self._lock:
            self.counters["degraded_ops"] += 1
            self._fail_seq += 1
            reason = f"{op}:{type(exc).__name__}"
            if self.state != STORE_DEGRADED:
                self.state = STORE_DEGRADED
                self.state_reason = reason
                log.warning(
                    f"feature store DEGRADED ({reason}: {exc}); failing "
                    "open — queries continue via recompute", kind="io")
                obs_events.emit("store_health", scope=self.scope,
                                state=STORE_DEGRADED, reason=reason)

    def _note_ok(self, fail_seq_before: int) -> None:
        """Claim recovery — ONLY valid when no failure landed since
        ``fail_seq_before`` (a journal/evict failure inside this very
        operation must keep the store DEGRADED, not be erased by the
        operation's own success path)."""
        with self._lock:
            if self._fail_seq != fail_seq_before:
                return
            if self.state == STORE_DEGRADED:
                self.state = STORE_OK
                reason = self.state_reason
                self.state_reason = None
                log.info("feature store recovered (operation succeeded "
                         f"after {reason})", kind="io")
                obs_events.emit("store_health", scope=self.scope,
                                state=STORE_OK, reason="recovered")

    # -- journal ------------------------------------------------------------

    def _journal(self, op: str, digest: str, *, size: Optional[int] = None,
                 sync: bool = False) -> None:
        """Append one journal record (fail-open; ``sync`` fsyncs under the
        durable contract — put/evict records, not touches)."""
        try:
            faults.store_io_hook("journal", self._journal_path())
            rec: Dict[str, Any] = {"op": op, "digest": digest,
                                   "t": round(time.time(), 3)}
            if size is not None:
                rec["bytes"] = int(size)
            # appends serialize under the store lock: resurrection-probe
            # dispatches resolve entries off the worker thread, and two
            # interleaved buffered writes would tear BOTH records
            with self._lock:
                if self._journal_f is None:
                    # self-healing: a failed compaction (or close) left no
                    # handle — reopen in append mode so a recovered disk
                    # resumes journaling without a process restart
                    if self._closed:
                        return
                    self._open_journal()
                self._journal_f.write(json.dumps(rec) + "\n")
                self._journal_f.flush()
                if sync and self.durable:
                    os.fsync(self._journal_f.fileno())
                self._journal_appends += 1
                if self._journal_needs_compaction():
                    # a warm long-lived process compacts in place (one
                    # touch record per hit would otherwise grow the file
                    # until the next restart)
                    self._compact_journal_locked()
        except (OSError, ValueError) as e:
            self._fail("journal", e)

    # -- read ---------------------------------------------------------------

    def contains(self, digest: str) -> bool:
        with self._lock:
            return digest in self._lru

    def get(self, digest: str) -> Optional[np.ndarray]:
        """Verified read.  Returns the array, or None for ANY of: no entry,
        checksum/header mismatch (entry quarantined), I/O failure (store
        degraded).  Never raises."""
        path = self._entry_path(digest)
        with self._lock:
            seq0 = self._fail_seq
        try:
            faults.store_io_hook("read", path)
            try:
                with open(path, "rb") as f:
                    raw = f.read()
            except FileNotFoundError:
                with self._lock:
                    self.counters["misses"] += 1
                    self._drop_index(digest)
                return None
            arr = self._verify(digest, path, raw)
            if arr is None:
                with self._lock:
                    self.counters["misses"] += 1
                return None
            with self._lock:
                self.counters["hits"] += 1
                if digest in self._lru:
                    self._lru.move_to_end(digest)
            self._journal("touch", digest)
            self._note_ok(seq0)
            return arr
        except Exception as e:  # noqa: BLE001 — the ladder: a store read
            # failure is a MISS with the store degraded, never a query
            # failure
            self._fail("read", e)
            with self._lock:
                self.counters["misses"] += 1
            return None

    def _verify(self, digest: str, path: str,
                raw: bytes) -> Optional[np.ndarray]:
        """Parse + verify one entry's bytes; quarantines and returns None
        on any mismatch."""
        nl = raw.find(b"\n")
        if nl < 0 or nl > _MAX_HEADER_BYTES:
            self._quarantine_entry(digest, path, "no header line")
            return None
        try:
            head = json.loads(raw[:nl])
        except ValueError:
            self._quarantine_entry(digest, path, "unparseable header")
            return None
        if not isinstance(head, dict) or head.get("magic") != _MAGIC:
            self._quarantine_entry(digest, path, "foreign file")
            return None
        if head.get("schema", 0) > SCHEMA_VERSION:
            self._quarantine_entry(digest, path,
                                   f"newer schema {head.get('schema')}")
            return None
        if head.get("digest") != digest \
                or head.get("fingerprint") != self.fingerprint:
            self._quarantine_entry(digest, path, "key mismatch")
            return None
        payload = raw[nl + 1:]
        want = head.get("checksum", "")
        got = "sha256:" + hashlib.sha256(payload).hexdigest()
        if want != got:
            self._quarantine_entry(digest, path, "checksum mismatch")
            return None
        try:
            shape = tuple(int(s) for s in head["shape"])
            arr = np.frombuffer(payload, dtype=np.dtype(head["dtype"]))
            return arr.reshape(shape).copy()
        except (KeyError, TypeError, ValueError) as e:
            self._quarantine_entry(digest, path,
                                   f"bad array header ({e})")
            return None

    def _quarantine_entry(self, digest: str, path: str, why: str) -> None:
        """Move a failed-verification entry aside (atomic rename — the
        poisoned bytes can never be served again, the evidence survives
        for the postmortem) and drop it from the index."""
        with self._lock:
            self.counters["corrupt"] += 1
            self._drop_index(digest)
        dest = None
        try:
            os.makedirs(self._quarantine_dir(), exist_ok=True)
            dest = os.path.join(
                self._quarantine_dir(),
                f"{self.fingerprint}.{os.path.basename(path)}"
                f".{int(time.time() * 1e3)}")
            os.replace(path, dest)
        except OSError as e:
            # even quarantine failing must not fail the query: drop the
            # index entry (already done) and degrade
            self._fail("quarantine", e)
            dest = None
        self._journal("quarantine", digest, sync=True)
        log.warning(f"feature store entry {digest} failed verification "
                    f"({why}); quarantined — recomputing", kind="validation")
        obs_events.emit("store_corrupt", scope=self.scope, digest=digest,
                        reason=why, quarantined_to=dest)

    def _drop_index(self, digest: str) -> None:
        size = self._lru.pop(digest, None)
        if size is not None:
            self._bytes -= size

    # -- write --------------------------------------------------------------

    def put(self, digest: str, array: np.ndarray) -> bool:
        """Two-phase atomic (and, by default, durable) commit of one entry.
        Fail-open: returns False (store degraded) instead of raising."""
        a = np.ascontiguousarray(array)
        # ONE payload materialization (an InLoc-resolution entry is
        # ~117 MB; hashing and writing the same buffer avoids two extra
        # full copies per commit on the dispatch path)
        payload = a.tobytes()
        head = {
            "magic": _MAGIC, "schema": SCHEMA_VERSION,
            "digest": digest, "fingerprint": self.fingerprint,
            "shape": list(a.shape), "dtype": a.dtype.str,
            "checksum": "sha256:" + hashlib.sha256(payload).hexdigest(),
            "t": round(time.time(), 3),
        }
        header = json.dumps(head, sort_keys=True).encode() + b"\n"
        size = len(header) + len(payload)
        path = self._entry_path(digest)
        with self._lock:
            seq0 = self._fail_seq
            self._inflight_puts.add(digest)
        try:
            try:
                faults.store_io_hook("write", path)
                atomic_write_bytes(
                    path, (header, payload), durable=self.durable,
                    # SIGKILL between payload write and rename lands here:
                    # the chaos suite proves a rerun sees NO visible entry
                    commit_hook=faults.store_commit_kill_hook)
                # post-commit corruption seam (bit-flip injection): the
                # NEXT verified read must catch what this plants
                faults.store_bitflip_hook(path)
            except (OSError, ValueError) as e:
                self._fail("write", e)
                return False
            with self._lock:
                self._drop_index(digest)
                self._lru[digest] = size
                self._bytes += size
                self.counters["puts"] += 1
        finally:
            with self._lock:
                self._inflight_puts.discard(digest)
        self._journal("put", digest, size=size, sync=True)
        self._enforce_budget()
        self._note_ok(seq0)
        return True

    def _enforce_budget(self) -> None:
        """LRU eviction down to ``budget_bytes`` (0 = unbounded).  An
        eviction failure degrades the store and stops this round — better
        over-budget than an eviction loop against a sick disk."""
        if self.budget_bytes <= 0:
            return
        while True:
            with self._lock:
                if self._bytes <= self.budget_bytes or len(self._lru) <= 1:
                    return
                # CLAIM the victim under the lock (drop it from the index
                # before touching the file): a second concurrent enforcer
                # can then never pick the same digest — no double-counted
                # evictions, no duplicate journal records.  In-flight puts
                # are skipped: evicting a digest whose fresh commit is
                # landing would delete the new entry's file.  (Residual
                # TOCTOU — a put of the claimed digest STARTING between
                # claim and remove — is benign by the ladder: the next
                # read takes the FileNotFoundError miss path and
                # recomputes; verified reads can never serve wrong bytes.)
                victim = next(
                    (d for d in self._lru if d not in self._inflight_puts),
                    None)
                if victim is None:
                    return
                digest, size = victim, self._lru[victim]
                self._drop_index(digest)
            path = self._entry_path(digest)
            try:
                faults.store_io_hook("evict", path)
                os.remove(path)
            except FileNotFoundError:
                pass
            except OSError as e:
                self._fail("evict", e)
                return
            with self._lock:
                self.counters["evictions"] += 1
            self._journal("evict", digest, size=size, sync=True)
            obs_events.emit("store_evict", scope=self.scope, digest=digest,
                            bytes=size)

    # -- the ladder, in one place ------------------------------------------

    def resolve(self, digest: str,
                compute: Callable[[], np.ndarray]
                ) -> Tuple[np.ndarray, str]:
        """``(features, status)`` — status ``"hit"`` (verified cached
        bytes), ``"miss"`` (no entry: computed + committed), or
        ``"recompute"`` (an entry existed but failed verification or I/O:
        quarantined/degraded, computed + rewritten).  The store can only
        make this SLOWER, never wrong and never fatal; ``compute()``
        exceptions are the caller's (device-error isolation owns them)."""
        had = self.contains(digest)
        arr = self.get(digest)
        if arr is not None:
            return arr, "hit"
        arr = np.asarray(compute())
        self.put(digest, arr)
        return arr, ("recompute" if had else "miss")

    # -- generations --------------------------------------------------------

    def gc_superseded(self, keep_generations: int = 0) -> int:
        """Remove sibling fingerprint directories whose WEIGHTS digest
        differs from this generation's (features computed under superseded
        weights are dead: they can never be read again — fingerprint
        mismatch is already a miss — so they only waste the budget).
        Same-weights siblings (another image_size/k/dtype consumer, e.g.
        the serving engine beside the InLoc eval) are live and kept.

        ``keep_generations`` is the live-rollout grace (serving/
        rollout.py): the N most-recently-touched superseded WEIGHTS
        generations survive — a rollback target's cache stays warm through
        promotion instead of cold-recomputing every pano.  0 (the default)
        is the old immediate-removal behavior.

        Returns the number of entries removed."""
        keep = _weights_segment(self.fingerprint)
        removed = 0
        removed_dirs = []
        try:
            names = os.listdir(self.root)
        except OSError as e:
            self._fail("gc", e)
            return 0
        spared: set = set()
        if keep_generations > 0:
            # rank superseded WEIGHTS segments by the newest mtime among
            # their dirs (a generation the pod served until the swap is
            # the freshest) and spare the top N whole
            newest: Dict[str, float] = {}
            for name in names:
                path = os.path.join(self.root, name)
                if name in (self.fingerprint, "quarantine") \
                        or not os.path.isdir(path):
                    continue
                seg = _weights_segment(name)
                if seg == keep:
                    continue
                try:
                    t = os.stat(path).st_mtime
                except OSError:
                    continue
                newest[seg] = max(newest.get(seg, 0.0), t)
            spared = {seg for seg, _ in sorted(
                newest.items(), key=lambda kv: kv[1],
                reverse=True)[:keep_generations]}
        for name in names:
            path = os.path.join(self.root, name)
            if name in (self.fingerprint, "quarantine") \
                    or not os.path.isdir(path):
                continue
            if _weights_segment(name) == keep:
                continue  # same weights, different consumer: live
            if _weights_segment(name) in spared:
                continue  # rollback grace: recent generation kept warm
            try:
                faults.store_io_hook("evict", path)
                n = sum(1 for f in os.listdir(path)
                        if f.endswith(_ENTRY_SUFFIX))
                shutil.rmtree(path)
            except OSError as e:
                self._fail("gc", e)
                continue
            removed += n
            removed_dirs.append(name)
        if removed_dirs:
            with self._lock:
                self.counters["gc_entries"] += removed
            fsync_dir(self.root)
            log.info(f"feature store GC: removed {removed} entr(ies) of "
                     f"{len(removed_dirs)} superseded generation(s): "
                     f"{removed_dirs}", kind="io")
            obs_events.emit("store_gc", scope=self.scope,
                            fingerprints=removed_dirs, entries=removed)
        return removed

    # -- probes -------------------------------------------------------------

    @property
    def entries(self) -> int:
        with self._lock:
            return len(self._lru)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def hit_pct(self) -> Optional[float]:
        """Verified-hit percentage over all lookups so far (None before
        the first lookup) — the cache-effectiveness number the bench gates
        and ``serve_top`` renders."""
        with self._lock:
            n = self.counters["hits"] + self.counters["misses"]
            if not n:
                return None
            return round(100.0 * self.counters["hits"] / n, 2)

    def health(self) -> Dict[str, Any]:
        """The store's section of the unified health document (surfaced on
        ``/healthz`` by the serving plane): state + reason + footprint +
        the counter set the ``ncnet_store_*`` metric families render."""
        with self._lock:
            return {
                "state": self.state,
                "reason": self.state_reason,
                "root": self.root,
                "fingerprint": self.fingerprint,
                "entries": len(self._lru),
                "bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "hit_pct": self.hit_pct(),
                "counters": dict(self.counters),
            }

    def flush_stats(self, **extra) -> Dict[str, Any]:
        """Emit one ``store_stats`` event carrying :meth:`health` (the
        durable copy ``run_report --store`` replays) and return it."""
        doc = self.health()
        fields = {"scope": self.scope, "store": doc, **extra}
        obs_events.emit("store_stats", **fields)
        return doc

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._journal_f is not None:
                try:
                    self._journal_f.close()
                except OSError:
                    pass
                self._journal_f = None

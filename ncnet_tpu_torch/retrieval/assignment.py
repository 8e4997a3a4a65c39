"""Rendezvous (highest-random-weight) pano→shard assignment, the port of
``ncnet_tpu/retrieval/assignment.py``: the same weights, so the port, the
JAX package and an offline builder place every pano alike.

The retrieval tier's coverage story starts here: every pano is owned by the
``replication`` highest-scoring shards under rendezvous hashing, so

  * the assignment is a pure function of ``(pano_id, shard_ids,
    replication)`` — the coordinator, every shard host, and the offline
    index builder all derive the SAME placement with zero shared state and
    zero coordination traffic;
  * a dead shard loses CAPACITY, not COVERAGE: each of its panos is still
    owned by ``replication - 1`` other shards, and the coordinator's
    scatter plan simply walks down the pano's replica ranking;
  * adding/removing a shard moves only the panos whose top-R ranking
    actually changes (~1/N of the database), never a full reshuffle — the
    property consistent placement exists for.

Scores are keyed on ``blake2b(pano_id | shard_id)`` so they are stable
across processes, platforms and Python hash randomization (``hash()`` is
per-process salted and would silently disagree between the coordinator and
its shards — the one bug class this module must make impossible).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = [
    "assignment_table",
    "rendezvous_score",
    "replica_shards",
]


def rendezvous_score(pano_id: str, shard_id: str) -> int:
    """The (pano, shard) rendezvous weight — a stable 64-bit integer."""
    h = hashlib.blake2b(f"{pano_id}|{shard_id}".encode("utf-8"),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big")


def replica_shards(pano_id: str, shard_ids: Sequence[str],
                   replication: int) -> Tuple[str, ...]:
    """The pano's replica ranking: shard ids ordered by descending
    rendezvous weight (id-ordered on the astronomically unlikely tie),
    truncated to ``replication``.  Rank 0 is the pano's primary; the
    coordinator's failover/hedging walks ranks 1..R-1."""
    if replication < 1:
        raise ValueError(f"replication must be >= 1, got {replication}")
    ranked = sorted(set(str(s) for s in shard_ids),
                    key=lambda s: (-rendezvous_score(pano_id, s), s))
    return tuple(ranked[:replication])


def assignment_table(pano_ids: Iterable[str], shard_ids: Sequence[str],
                     replication: int) -> Dict[str, List[str]]:
    """``{shard_id: [pano_id, ...]}`` — every pano appears in exactly
    ``min(replication, len(shard_ids))`` shard lists.  This is what a shard
    host serves and what the index builder materializes; per-shard lists
    preserve the input pano order (deterministic manifests)."""
    table: Dict[str, List[str]] = {str(s): [] for s in shard_ids}
    for pano in pano_ids:
        for sid in replica_shards(str(pano), shard_ids, replication):
            table[sid].append(str(pano))
    return table

"""Coarse-index manifests: the durable map from pano names to store
entries, the port of ``ncnet_tpu/retrieval/index.py`` (the same documents,
so either package reads an index the other wrote).

An index manifest is the small JSON document
``ncnet_tpu_torch/tools/build_coarse_index.py``
writes next to the feature store: the coarse generation's fingerprint +
factor + extractor, and ``{pano_name: content_digest}`` for every pano
whose coarse volume was committed.  Shard hosts load it to know WHAT they
serve (the rendezvous assignment then says WHICH subset), the coordinator
loads it to plan scatter coverage, and the InLoc in-system shortlist loads
it to score queries locally.  Manifests from a striped build merge
(:func:`load_index_manifests`) — but only when fingerprint/factor/extractor
agree exactly; a mixed-generation index is refused, never silently scored.
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

INDEX_SCHEMA = 1

__all__ = [
    "INDEX_SCHEMA",
    "load_index_manifests",
    "local_shortlist",
    "write_index_manifest",
]


def write_index_manifest(path: str, *, fingerprint: str, factor: int,
                         extractor: str, panos: Dict[str, str],
                         meta: Optional[Dict[str, Any]] = None) -> None:
    """Atomically write one index manifest (tmp + rename, the store's
    two-phase discipline: a SIGKILLed build rerun sees the old manifest or
    the new one, never a torn prefix)."""
    doc = {
        "schema": INDEX_SCHEMA,
        "fingerprint": str(fingerprint),
        "factor": int(factor),
        "extractor": str(extractor),
        "panos": {str(k): str(v) for k, v in panos.items()},
    }
    if meta:
        doc["meta"] = dict(meta)
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, sort_keys=True, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_index_manifests(paths) -> Dict[str, Any]:
    """Load + merge index manifest(s).  ``paths`` is one path, a glob
    pattern, or an iterable of either.  Raises ``ValueError`` on schema,
    fingerprint, factor or extractor disagreement — a merged index must be
    one coherent generation."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [os.fspath(paths)]
    files: List[str] = []
    for p in paths:
        p = os.fspath(p)
        hits = sorted(_glob.glob(p)) if _glob.has_magic(p) else [p]
        if not hits:
            raise ValueError(f"index manifest glob matched nothing: {p}")
        files.extend(hits)
    if not files:
        raise ValueError("no index manifest paths given")
    merged: Optional[Dict[str, Any]] = None
    for path in files:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or doc.get("schema") != INDEX_SCHEMA:
            raise ValueError(
                f"{path}: index schema "
                f"{doc.get('schema') if isinstance(doc, dict) else '?'} != "
                f"{INDEX_SCHEMA} — refusing a manifest this build does not "
                "understand")
        if merged is None:
            merged = {"schema": INDEX_SCHEMA,
                      "fingerprint": str(doc["fingerprint"]),
                      "factor": int(doc["factor"]),
                      "extractor": str(doc.get("extractor", "backbone")),
                      "panos": dict(doc.get("panos") or {}),
                      "sources": [path]}
            continue
        for key in ("fingerprint", "factor", "extractor"):
            a, b = merged[key], doc.get(
                key, "backbone" if key == "extractor" else None)
            if (int(a) if key == "factor" else str(a)) != \
                    (int(b) if key == "factor" else str(b)):
                raise ValueError(
                    f"{path}: {key} {b!r} != {a!r} — manifests from "
                    "different index generations do not merge")
        merged["panos"].update(doc.get("panos") or {})
        merged["sources"].append(path)
    return merged


def local_shortlist(store, index: Dict[str, Any], desc: np.ndarray,
                    topk: int, compute=None) -> Dict[str, Any]:
    """Single-process retrieval pass (the InLoc in-system shortlist and
    the bitflip-recovery test both run this): score ``desc`` against every
    indexed pano's coarse volume read through the store's verified-read /
    quarantine / recompute ladder.  ``compute`` maps a pano name to a
    freshly computed coarse volume (enables transparent recompute of a
    corrupted entry); without it an unreadable entry lowers ``coverage``
    instead — never a crash, never unverified bytes.

    Returns ``{"scores": ((pano, score), ...) top-k, "coverage": float,
    "consulted": n, "unavailable": [names]}`` — the same outcome-honest
    coverage contract the distributed tier reports."""
    from ncnet_tpu_torch.retrieval.scoring import score_coarse_volume, top_k

    panos = index["panos"]
    scores: Dict[str, float] = {}
    unavailable: List[str] = []
    for name, digest in panos.items():
        if compute is not None:
            try:
                vol, _status = store.resolve(
                    digest, lambda name=name: compute(name))
            except Exception:  # noqa: BLE001 — a pano that cannot be
                # scored lowers coverage; it must not fail the query
                unavailable.append(name)
                continue
        else:
            vol = store.get(digest)
            if vol is None:
                unavailable.append(name)
                continue
        scores[name] = score_coarse_volume(desc, vol)
    total = max(1, len(panos))
    return {
        "scores": top_k(scores, topk),
        "coverage": round(len(scores) / total, 6),
        "consulted": len(scores),
        "total": len(panos),
        "unavailable": unavailable,
    }

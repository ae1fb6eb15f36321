"""Versioned KV result store — the CouchDB analogue.

The port's copy of ``repro.serving.store`` (framework-free; the port
imports nothing of ``repro``).

The paper's consumer writes a probability array into CouchDB under the
request key; the Flask backend polls for it.  The transferable semantics
reproduced here: versioned documents (MVCC-style conflict detection on
put), idempotent upsert for at-least-once consumers, and polling reads.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional


class Conflict(Exception):
    pass


@dataclasses.dataclass
class Document:
    key: str
    value: Any
    rev: int


class ResultStore:
    def __init__(self):
        self._docs: Dict[str, Document] = {}
        self._lock = threading.Lock()
        self.puts = 0
        self.gets = 0

    def put(self, key: str, value: Any, rev: Optional[int] = None) -> int:
        """MVCC put: ``rev`` must match the current revision (None = create
        or unconditional upsert of a brand-new key)."""
        with self._lock:
            self.puts += 1
            cur = self._docs.get(key)
            if cur is not None and rev is not None and rev != cur.rev:
                raise Conflict(f"{key}: rev {rev} != {cur.rev}")
            new_rev = (cur.rev + 1) if cur else 1
            self._docs[key] = Document(key, value, new_rev)
            return new_rev

    def upsert_idempotent(self, key: str, value: Any) -> int:
        """At-least-once-friendly write: re-delivery of the same result is
        a no-op rather than a version bump."""
        with self._lock:
            self.puts += 1
            cur = self._docs.get(key)
            if cur is not None:
                return cur.rev
            self._docs[key] = Document(key, value, 1)
            return 1

    def get(self, key: str) -> Optional[Document]:
        with self._lock:
            self.gets += 1
            return self._docs.get(key)

    def poll(self, key: str) -> Optional[Any]:
        doc = self.get(key)
        return doc.value if doc else None

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._docs.pop(key, None) is not None

    def __len__(self) -> int:
        return len(self._docs)

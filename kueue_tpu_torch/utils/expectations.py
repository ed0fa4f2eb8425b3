"""UID expectation store for in-flight asynchronous operations.

The port of ``kueue_tpu/utils/expectations.py``, unchanged.

Reference: pkg/util/expectations/store.go (Store — per-key sets of UIDs we
are waiting to observe a change for through event handlers) and
pkg/scheduler/preemption/expectations/expectations.go (the preemption
instance). The scheduler uses it to avoid re-issuing a preemption for a
target whose eviction was already issued but not yet observed back through
the watch stream (preemption.go:216), and releases the expectation when the
target is admitted again (scheduler.go:882, kueue#11480) or the eviction
apply fails (preemption.go:240).
"""

from __future__ import annotations

import threading


class Store:
    """pkg/util/expectations/store.go:30."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._store: dict[str, set[str]] = {}

    def expect_uids(self, key: str, uids: list[str]) -> None:
        """Record UIDs whose observation we now await for ``key``."""
        with self._lock:
            stored = self._store.get(key)
            if stored is None:
                self._store[key] = set(uids)
            else:
                stored.update(uids)

    def observed_uid(self, key: str, uid: str) -> None:
        """An event handler saw the change for ``uid``; clean up the key
        once every expected UID has been observed."""
        with self._lock:
            stored = self._store.get(key)
            if stored is None:
                return
            stored.discard(uid)
            if not stored:
                del self._store[key]

    def observed_uids(self, items) -> None:
        """Batched :meth:`observed_uid`: one lock round trip for a whole
        admitted batch (``items`` is an iterable of ``(key, uid)``), and
        a free pass when nothing is expected — the steady serving shape."""
        with self._lock:
            store = self._store
            if not store:
                return
            for key, uid in items:
                stored = store.get(key)
                if stored is None:
                    continue
                stored.discard(uid)
                if not stored:
                    del store[key]

    def satisfied(self, key: str) -> bool:
        """True when nothing is pending for ``key``."""
        with self._lock:
            return key not in self._store

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

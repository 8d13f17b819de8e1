"""Durable GCS table storage (reference:
``src/ray/gcs/store_client/redis_store_client.h:28`` RedisStoreClient and
the in-memory fallback ``in_memory_store_client.h``; the reference
persists GCS tables to an external Redis for fault tolerance, restored
via ``GcsInitData`` at server start).

Here: one sqlite file in WAL mode (crash-safe, stdlib, zero deps).
Values are pickled; the GCS writes through on every mutation and bulk-
loads tables at startup after a crash/restart.
"""

from __future__ import annotations

import os
import pickle
import sqlite3
import threading
from typing import Any, Dict, Iterable, Optional, Tuple


class GcsStorage:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute("PRAGMA synchronous=NORMAL")
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS tables ("
                "tbl TEXT NOT NULL, key BLOB NOT NULL, value BLOB NOT NULL, "
                "PRIMARY KEY (tbl, key))")
            self._db.commit()
        self.path = path

    def put(self, table: str, key: bytes, value: Any) -> None:
        blob = pickle.dumps(value, protocol=5)
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO tables (tbl, key, value) "
                "VALUES (?, ?, ?)", (table, key, blob))
            self._db.commit()

    def delete(self, table: str, key: bytes) -> None:
        with self._lock:
            self._db.execute(
                "DELETE FROM tables WHERE tbl = ? AND key = ?", (table, key))
            self._db.commit()

    def load_table(self, table: str) -> Dict[bytes, Any]:
        with self._lock:
            rows = self._db.execute(
                "SELECT key, value FROM tables WHERE tbl = ?",
                (table,)).fetchall()
        out: Dict[bytes, Any] = {}
        for key, blob in rows:
            try:
                out[bytes(key)] = pickle.loads(blob)
            except Exception:
                continue  # skip torn/unreadable records
        return out

    def items(self) -> Iterable[Tuple[str, bytes, Any]]:
        with self._lock:
            rows = self._db.execute(
                "SELECT tbl, key, value FROM tables").fetchall()
        for tbl, key, blob in rows:
            try:
                yield tbl, bytes(key), pickle.loads(blob)
            except Exception:
                continue

    def close(self) -> None:
        with self._lock:
            try:
                self._db.commit()
                self._db.close()
            except Exception:
                pass


def open_storage(path: Optional[str]) -> Optional[GcsStorage]:
    return GcsStorage(path) if path else None

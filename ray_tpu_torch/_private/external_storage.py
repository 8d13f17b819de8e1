"""Spill storage backends (reference: ``_private/external_storage.py:72``
filesystem / :246 smart_open(S3) backends for object spilling)."""

from __future__ import annotations

import os
from typing import Optional


class ExternalStorage:
    def spill(self, object_id: bytes, data: bytes) -> str:
        """Persist; returns a restore URL."""
        raise NotImplementedError

    def restore(self, url: str) -> bytes:
        raise NotImplementedError

    def delete(self, url: str) -> None:
        raise NotImplementedError

    def size(self, url: str) -> int:
        return len(self.restore(url))

    def restore_range(self, url: str, offset: int, length: int) -> bytes:
        """Default range read materializes the whole blob; backends with
        seekable storage override (FileSystemStorage does)."""
        return self.restore(url)[offset:offset + length]


class FileSystemStorage(ExternalStorage):
    """Spill to a local directory (reference:
    ``external_storage.py:72`` FileSystemStorage)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def spill(self, object_id: bytes, data: bytes) -> str:
        path = os.path.join(self.directory, object_id.hex())
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return f"file://{path}"

    def restore(self, url: str) -> bytes:
        assert url.startswith("file://"), url
        with open(url[len("file://"):], "rb") as f:
            return f.read()

    def size(self, url: str) -> int:
        return os.path.getsize(url[len("file://"):])

    def restore_range(self, url: str, offset: int, length: int) -> bytes:
        """Range read for chunked cross-node restore (a spilled object is
        served in ``fetch_chunk_bytes`` pieces like a live one)."""
        with open(url[len("file://"):], "rb") as f:
            f.seek(offset)
            return f.read(length)

    def delete(self, url: str) -> None:
        try:
            os.unlink(url[len("file://"):])
        except OSError:
            pass


def create_storage(spec: Optional[dict], default_dir: str) -> ExternalStorage:
    """Factory (reference: external_storage.setup_external_storage).
    ``spec``: {"type": "filesystem", "params": {"directory_path": ...}};
    S3/smart_open is environment-gated (no egress here)."""
    if not spec or spec.get("type") in (None, "filesystem"):
        params = (spec or {}).get("params", {})
        return FileSystemStorage(
            params.get("directory_path", default_dir))
    raise ValueError(
        f"unsupported external storage type {spec.get('type')!r} "
        "(filesystem only in this environment)")

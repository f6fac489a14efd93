"""Phase-boundary checkpoint/resume — the port's copy of
cmsbwt_tpu/utils/checkpoint.py, with the same ``.npz`` layout and
fingerprints, so either package resumes from the other's files.

The reference has no crash recovery — its only persistence is the
``.phrases`` spill file (ref CMS-BWT-functions.cpp:1135-1416) which bounds
RAM, not failures. Here each block of the blocked dense scan is serialized
after completion and reloaded on restart; a fingerprint of the inputs and
the relevant config guards staleness.
"""
from __future__ import annotations

import hashlib
import json
import os
import secrets
from typing import Optional

import numpy as np


class CheckpointManager:
    """Disk cache keyed by (name, fingerprint).

    Concurrency-safe by construction: the final filename embeds the
    fingerprint (so concurrent runs over *different* inputs use different
    slots instead of thrashing one `<name>.npz`), and the temporary file
    carries a per-process random suffix before an atomic ``os.replace``
    (so two writers of the *same* slot cannot interleave writes or race
    the rename — the loser just overwrites with identical content).
    """

    def __init__(self, directory: Optional[str]):
        self.dir = directory
        if directory:
            os.makedirs(directory, exist_ok=True)

    def _path(self, name: str, fingerprint: str) -> str:
        return os.path.join(self.dir, f"{name}.{fingerprint}.npz")

    @staticmethod
    def fingerprint(**parts) -> str:
        blob = json.dumps(parts, sort_keys=True, default=str).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def save(self, name: str, fingerprint: str, arrays: dict) -> None:
        if not self.dir:
            return
        tmp = os.path.join(
            self.dir,
            f".{name}.{fingerprint}.{os.getpid()}.{secrets.token_hex(4)}.tmp")
        try:
            with open(tmp, "wb") as f:
                np.savez(f, __fingerprint__=np.frombuffer(
                    fingerprint.encode(), dtype=np.uint8), **arrays)
            os.replace(tmp, self._path(name, fingerprint))
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    def load(self, name: str, fingerprint: str) -> Optional[dict]:
        if not self.dir:
            return None
        path = self._path(name, fingerprint)
        if not os.path.exists(path):
            return None
        try:
            data = np.load(path)
            fp = bytes(data["__fingerprint__"]).decode()
        except Exception:
            return None
        if fp != fingerprint:
            return None
        return {k: data[k] for k in data.files if k != "__fingerprint__"}


def file_stamp(path: str) -> dict:
    st = os.stat(path)
    return {"path": os.path.abspath(path), "size": st.st_size,
            "mtime": int(st.st_mtime)}

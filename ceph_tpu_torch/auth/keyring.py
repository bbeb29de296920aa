"""Keyring: entity name -> shared secret.

Re-expresses reference src/auth/KeyRing.{h,cc} at the fidelity the
cluster needs: named entities ("mon.", "osd.3", "client.admin") with
random secrets and optional caps, JSON-persisted (the reference's
INI-style keyring files carry base64 keys + caps the same way).
"""

from __future__ import annotations

import base64
import json
import os


class Keyring:
    def __init__(self) -> None:
        self._keys: dict[str, bytes] = {}
        self.caps: dict[str, str] = {}

    def gen_key(self, entity: str, caps: str = "allow *") -> bytes:
        key = os.urandom(16)
        self._keys[entity] = key
        self.caps[entity] = caps
        return key

    def add(self, entity: str, key: bytes, caps: str = "allow *") -> None:
        self._keys[entity] = bytes(key)
        self.caps[entity] = caps

    def get(self, entity: str) -> bytes | None:
        return self._keys.get(entity)

    def __contains__(self, entity: str) -> bool:
        return entity in self._keys

    # -- replication (AuthMonitor value; mon/monitor.py) ---------------------

    def to_json(self) -> dict:
        return {e: {"key": base64.b64encode(k).decode(),
                    "caps": self.caps.get(e, "")}
                for e, k in self._keys.items()}

    def replace_from_json(self, j: dict) -> None:
        """Adopt a committed auth map wholesale (the replicated value is
        the full entity set, like the committed OSDMap is the full map)."""
        self._keys = {e: base64.b64decode(rec["key"])
                      for e, rec in j.items()}
        self.caps = {e: rec.get("caps", "") for e, rec in j.items()}

    def remove(self, entity: str) -> None:
        self._keys.pop(entity, None)
        self.caps.pop(entity, None)

    def entities(self) -> list[str]:
        return sorted(self._keys)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({e: {"key": base64.b64encode(k).decode(),
                           "caps": self.caps.get(e, "")}
                       for e, k in self._keys.items()}, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "Keyring":
        kr = cls()
        with open(path) as f:
            for e, rec in json.load(f).items():
                kr.add(e, base64.b64decode(rec["key"]),
                       rec.get("caps", ""))
        return kr

"""Elastic membership / failure detection.

Copy of ``paddlebox_tpu/elastic.py`` (host code: files, threads; no
torch).  ≙ ElasticManager (fleet/elastic/manager.py:131): ranks register
under a watch prefix with a TTL'd heartbeat, a watcher notices
scale-in/out or dead ranks and triggers restart/re-rendezvous.  The
reference uses etcd (manager.py:217-233 key writes); a one-host fleet
gets a shared-filesystem store instead (NFS in production, tmpdir in
tests) — same contract: register, heartbeat, watch, notify.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional


class FileStore:
    """TTL'd key registry on a shared directory (≙ the etcd prefix)."""

    def __init__(self, root: str, ttl: float = 10.0):
        self.root = root
        self.ttl = ttl
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "_") + ".json")

    def put(self, key: str, value: Dict) -> None:
        tmp = self._path(key) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"value": value, "ts": time.time()}, f)
        os.replace(tmp, self._path(key))

    def get(self, key: str) -> Optional[Dict]:
        try:
            with open(self._path(key)) as f:
                rec = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        if time.time() - rec["ts"] > self.ttl:
            return None
        return rec["value"]

    def alive_keys(self) -> List[str]:
        out = []
        for fn in os.listdir(self.root):
            if not fn.endswith(".json"):
                continue
            key = fn[:-5]
            if self.get(key) is not None:
                out.append(key)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


class ElasticManager:
    """Register + heartbeat this rank; watch membership; fire callbacks on
    change (≙ manager.py watch loop + scale in/out decision)."""

    def __init__(self, store: FileStore, rank: int, world_size: int,
                 heartbeat_interval: float = 2.0):
        self.store = store
        self.rank = rank
        self.world_size = world_size
        self.interval = heartbeat_interval
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._callbacks: List[Callable[[List[str]], None]] = []
        self._last_members: Optional[List[str]] = None

    def register(self) -> None:
        self.store.put(f"rank-{self.rank:05d}",
                       {"rank": self.rank, "host": os.uname().nodename,
                        "pid": os.getpid()})

    def on_membership_change(self, fn: Callable[[List[str]], None]) -> None:
        self._callbacks.append(fn)

    def start(self) -> None:
        self.register()

        def heartbeat():
            while not self._stop.wait(self.interval):
                self.register()

        def watch():
            while not self._stop.wait(self.interval / 2):
                members = self.store.alive_keys()
                if self._last_members is not None and \
                        members != self._last_members:
                    for fn in self._callbacks:
                        fn(members)
                self._last_members = members

        for target in (heartbeat, watch):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        self.store.delete(f"rank-{self.rank:05d}")

    def healthy(self) -> bool:
        return len(self.store.alive_keys()) == self.world_size

"""Bounded MPMC channel — the backbone primitive of the host data pipeline.

≙ framework/channel.h:39 (ChannelObject) with Reader/Writer adapters
(channel.h:330,382).  All pipeline stages (read -> parse -> shuffle -> merge ->
batch) hand SlotRecord batches through these.  Unlike the reference we move
numpy record *batches* (struct-of-arrays), not individual records, so Python
overhead amortizes.
"""

from __future__ import annotations

import collections
import threading

from paddlebox_tpu_torch.utils import lockdep
from typing import Any, Iterable, List, Optional


class ChannelClosed(Exception):
    pass


class Channel:
    """Bounded blocking MPMC channel with block-write semantics.

    write/read of single items or batches; ``close()`` wakes all blocked
    readers (who then drain the remaining items and get EOF).
    """

    def __init__(self, capacity: int = 0):
        self._cap = capacity if capacity > 0 else float("inf")
        self._q: collections.deque = collections.deque()
        self._closed = False
        self._lock = lockdep.lock("utils.channel.Channel._lock")
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)

    def put(self, item: Any) -> bool:
        with self._lock:
            while len(self._q) >= self._cap and not self._closed:
                self._not_full.wait()
            if self._closed:
                return False
            self._q.append(item)
            self._not_empty.notify()
            return True

    def put_many(self, items: Iterable[Any]) -> int:
        n = 0
        for it in items:
            if not self.put(it):
                break
            n += 1
        return n

    def get(self, timeout: Optional[float] = None) -> Any:
        """Blocking read; raises ChannelClosed on EOF (closed and drained)."""
        with self._lock:
            while not self._q and not self._closed:
                if not self._not_empty.wait(timeout):
                    raise TimeoutError("channel read timed out")
            if self._q:
                item = self._q.popleft()
                self._not_full.notify()
                return item
            raise ChannelClosed()

    def get_many(self, max_items: int) -> List[Any]:
        """Read up to max_items (at least 1 unless EOF -> empty list)."""
        out: List[Any] = []
        with self._lock:
            while not self._q and not self._closed:
                self._not_empty.wait()
            while self._q and len(out) < max_items:
                out.append(self._q.popleft())
            self._not_full.notify_all()
        return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def reopen(self) -> None:
        with self._lock:
            self._closed = False

    def size(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def __iter__(self):
        while True:
            try:
                yield self.get()
            except ChannelClosed:
                return

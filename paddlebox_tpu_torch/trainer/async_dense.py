"""Async host-side dense table — ≙ BoxPSAsynDenseTable.

Port of ``paddlebox_tpu/trainer/async_dense.py``.  Reference semantics
(device_worker.h:803, boxps_worker.cc:133-372): the dense parameters live
in a CPU-side table; each worker *pulls* a snapshot, *pushes* its dense
gradients into a channel after the backward, and a background update
thread drains the channel applying an Adam rule, so workers never block
on each other's dense updates (TrainerDesc async_mode,
trainer_desc.proto:121).

The table holds f32 numpy copies of the parameters keyed by name, and its
thread touches numpy only: it makes no CUDA call, as no worker thread of
the port does.  The trainer (``dense_sync_mode="async_table"``) copies
each step's dense grads to the host on its own thread and pushes them
here, and copies :meth:`pull` back into the module every
``sync_weight_step`` batches.  The update arithmetic is the JAX
package's expression for expression, so the same pushed grads give the
same bits.  Staleness is bounded by the channel capacity.
"""

from __future__ import annotations

import threading
from typing import Dict, Mapping, Optional

import numpy as np

from paddlebox_tpu_torch.utils import lockdep
from paddlebox_tpu_torch.utils.channel import Channel, ChannelClosed

Arrays = Dict[str, np.ndarray]


class AsyncDenseTable:
    def __init__(self, params: Mapping[str, np.ndarray],
                 learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 queue_capacity: int = 64):
        """``params``: name → array (numpy, or anything ``np.array``
        takes); the table keeps f32 copies."""
        self._lr = learning_rate
        self._b1, self._b2, self._eps = beta1, beta2, eps
        self._lock = lockdep.lock("trainer.async_dense.AsyncDenseTable._lock")
        self._params = {k: np.array(v, np.float32) for k, v in params.items()}
        self._m = {k: np.zeros_like(v) for k, v in self._params.items()}
        self._v = {k: np.zeros_like(v) for k, v in self._params.items()}
        self._t = 0
        self._pushed = 0
        self._applied = 0
        self._error: Optional[BaseException] = None
        self._ch: Channel = Channel(capacity=queue_capacity)
        self._thread = threading.Thread(target=self._update_loop,
                                        name="pbox-async-dense",
                                        daemon=True)
        self._thread.start()

    @property
    def thread(self) -> threading.Thread:
        """The update thread (numpy only)."""
        return self._thread

    @property
    def pushed(self) -> int:
        return self._pushed

    @property
    def applied(self) -> int:
        return self._applied

    # ------------------------------------------------------------------
    def pull(self) -> Arrays:
        """Snapshot → host copies (≙ PullDense, boxps_worker.cc:226)."""
        with self._lock:
            return {k: np.copy(v) for k, v in self._params.items()}

    def push(self, grads: Mapping[str, np.ndarray]) -> None:
        """Enqueue one batch's dense grads (≙ PushDense → channel,
        boxps_worker.cc:252); blocks only when the channel is full.  The
        grads must already be host arrays: the update thread makes no
        device call, so a tensor is refused here, on the caller's
        thread."""
        for k, g in grads.items():
            if not isinstance(g, np.ndarray):
                raise TypeError(f"AsyncDenseTable.push: grad {k!r} is a "
                                f"{type(g).__name__}, not a host array")
        self._pushed += 1
        self._ch.put({k: np.asarray(g, np.float32) for k, g in grads.items()})

    def _update_loop(self) -> None:
        """≙ AsyncUpdate/ThreadUpdate (boxps_worker.cc:260-330): drain the
        channel and apply one Adam step per pushed batch."""
        try:
            self._update_loop_inner()
        except BaseException as e:  # surfaced in drain(), not lost
            self._error = e

    def _update_loop_inner(self) -> None:
        while True:
            try:
                g = self._ch.get()
            except ChannelClosed:
                return
            with self._lock:
                self._t += 1
                t = self._t
                bc1 = 1.0 - self._b1 ** t
                bc2 = 1.0 - self._b2 ** t
                for k, p in self._params.items():
                    m, v, gr = self._m[k], self._v[k], g[k]
                    m[:] = self._b1 * m + (1 - self._b1) * gr
                    v[:] = self._b2 * v + (1 - self._b2) * gr * gr
                    p[:] = p - self._lr * (m / bc1) / (
                        np.sqrt(v / bc2) + self._eps)
                self._applied += 1

    # ------------------------------------------------------------------
    def drain(self) -> None:
        """Block until every pushed batch has been *applied* (an empty
        channel can still have one item mid-apply in the thread).  Raises
        instead of waiting forever if the update thread died."""
        while self._applied < self._pushed:
            if self._error is not None:
                raise RuntimeError(
                    "async dense update thread failed with "
                    f"{self._pushed - self._applied} pushes pending"
                ) from self._error
            if not self._thread.is_alive():
                raise RuntimeError(
                    "async dense update thread exited with "
                    f"{self._pushed - self._applied} pushes pending")
            threading.Event().wait(0.002)

    def finalize(self) -> Arrays:
        """Stop the update thread and return the final parameters
        (≙ Finalize copying the table back, boxps_worker.cc:214)."""
        self.drain()
        self._ch.close()
        self._thread.join(timeout=5.0)
        return self.pull()

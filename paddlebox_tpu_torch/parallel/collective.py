"""The trainer fleet's host collective.

Port of the host half of ``paddlebox_tpu/parallel/collective.py``
(:class:`FleetCollective` — ≙ GlooWrapper/boxps::MPICluster): barriers
and dense-state reduction between trainer ranks (threads or processes),
riding the PS tier's rid-dedup'd barrier/dense verbs so every operation
is replay-safe across a trainer crash + supervisor restart.  PB604
discipline applies here the same as to locks: every wait carries a
deadline, and expiry raises the typed :class:`PeerDead` instead of
hanging the fleet.  Host code only (numpy over a PSClient; no torch).
The named-axis device collectives of the JAX module are not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.utils.monitor import stat_add, stat_observe

flags.define_flag(
    "fleet_deadline_s", 180.0,
    "total budget for any one trainer-fleet collective wait (barrier / "
    "dense fold); a peer absent past this raises PeerDead — sized to "
    "ride out one supervisor restart (backoff + resume replay)")


class PeerDead(ConnectionError):
    """A fleet peer stayed absent from a collective past the deadline."""


def namespaced_group(base: str, rank: Optional[int], tail: str) -> str:
    """Sanctioned rid-group constructor for fleet/trainer code (pboxlint
    PB806): ``<base>.t<rank>:<tail>``.  The text before the colon is the
    server dedup window's token, so all of one trainer's chunk rids share
    one window — and distinct ranks NEVER share one, which is what makes
    per-trainer replay exactly-once (rank r's re-driven chunks can only
    dedup against rank r's own landed chunks).

    ``rank=None`` is the leader-lifecycle namespace (``<base>:<tail>``):
    verbs that must be exactly-once across a leader FAILOVER (end_day)
    pin one group independent of which rank drives them.
    """
    tok = base if rank is None else f"{base}.t{rank}"
    return f"{tok}:{tail}"


class FleetCollective:
    """Replay-safe barriers + deterministic dense reduction for the
    trainer fleet, over a PSClient.

    Every barrier rid is deterministic in (rank, tag) — a restarted
    trainer re-driving its pass replays the SAME rids, so barriers it
    already joined answer from the dedup window and barriers the fleet
    is still waiting on get its registration exactly once.  Calls retry
    under FLAGS_fleet_deadline_s (riding out a peer's supervisor
    restart), with an optional ``poke`` callback between attempts — the
    runner's leader-duty hook, so a rank waiting on a dead leader can
    take over its lifecycle work instead of deadlocking.
    """

    def __init__(self, client, rank: int, world: int,
                 namespace: str = "fleet",
                 deadline_s: Optional[float] = None):
        self.client = client
        self.rank = int(rank)
        self.world = int(world)
        self.namespace = namespace
        self.deadline_s = (float(flags.get_flags("fleet_deadline_s"))
                           if deadline_s is None else float(deadline_s))

    def _rid(self, kind: str, tag: str) -> str:
        return namespaced_group(self.namespace, self.rank,
                                f"{kind}.{tag}")

    def _retry(self, tag: str, fn: Callable[[], None],
               poke: Optional[Callable[[], None]]) -> None:
        deadline = time.monotonic() + self.deadline_s
        while True:
            try:
                fn()
                return
            except ConnectionError:
                pass
            except RuntimeError as e:
                # the PS barrier window rolled back (a peer absent for
                # its 60s wait) — same remedy as a dropped connection:
                # re-drive the SAME rid until the fleet deadline
                if "timeout" not in str(e) and "timed out" not in str(e):
                    raise
            if time.monotonic() >= deadline:
                raise PeerDead(
                    f"fleet collective {tag!r} incomplete after "
                    f"{self.deadline_s:.0f}s — a peer is gone past the "
                    f"restart budget")
            stat_add("trainer.fleet.collective_retries")
            if poke is not None:
                poke()

    def barrier(self, tag: str, timeout: float = 20.0,
                poke: Optional[Callable[[], None]] = None) -> None:
        """Fleet-wide barrier named by ``tag`` (deterministic rid —
        replayable).  All ranks must pass the same sequence of barriers
        (the PS barrier is generation-matched by arrival order)."""
        t0 = time.monotonic()
        self._retry(tag, lambda: self.client.barrier(
            self.world, timeout=timeout, rid=self._rid("bar", tag)), poke)
        stat_observe("trainer.fleet.barrier_wait_s",
                     time.monotonic() - t0)

    def allreduce(self, arrs: Dict[str, np.ndarray], tag: str,
                  timeout: float = 20.0,
                  poke: Optional[Callable[[], None]] = None
                  ) -> Dict[str, np.ndarray]:
        """Cross-rank sum via the PS allreduce verb, deadline-bounded and
        replay-safe (deterministic rid).  NOTE: the server folds
        contributions in ARRIVAL order — use only where fp association
        order doesn't matter (counters, diagnostics).  Bit-critical
        folds go through :meth:`reduce_slots`."""
        t0 = time.monotonic()
        out: List[Dict[str, np.ndarray]] = []
        self._retry(tag, lambda: out.append(self.client.allreduce(
            arrs, self.world, key=tag, timeout=timeout,
            rid=self._rid("ar", tag))), poke)
        stat_observe("trainer.fleet.allreduce_wait_s",
                     time.monotonic() - t0)
        return out[-1]

    def reduce_slots(self, prefix: str, mine: Dict[int, np.ndarray],
                     n_slots: int, tag: str,
                     poke: Optional[Callable[[], None]] = None
                     ) -> List[np.ndarray]:
        """Deterministic fleet reduction: each rank publishes its owned
        slots (absolute dense writes — idempotent under restart replay),
        a barrier fences publication, then EVERY rank reads all slots in
        slot order.  The caller folds in that fixed order, so the fp
        operation sequence is identical at any fleet size — the property
        the PS allreduce verb (arrival-order summation) cannot give.
        This is the fleet's dense-grad sync path."""
        t0 = time.monotonic()
        for v in sorted(mine):
            vec = np.asarray(mine[v])
            self._retry(f"{tag}.push.{v}",
                        lambda vec=vec, v=v: self.client.push_dense(
                            f"{prefix}.{v}", vec), poke)
        self.barrier(f"{tag}.fence", poke=poke)
        out: List[np.ndarray] = []
        for v in range(n_slots):
            got: List[np.ndarray] = []
            self._retry(f"{tag}.pull.{v}",
                        lambda v=v: got.append(self.client.pull_dense(
                            f"{prefix}.{v}")), poke)
            out.append(got[-1])
        stat_observe("trainer.fleet.allreduce_wait_s",
                     time.monotonic() - t0)
        return out

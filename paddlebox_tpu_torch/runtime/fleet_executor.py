"""Actor-style DAG micro-runtime.

Copy of ``paddlebox_tpu/runtime/fleet_executor.py`` with the import paths
rewritten; host threads over ``utils/channel`` (no torch: a compute
node's ``fn`` decides where its work runs).  One fault of the reference
is repaired here: its source sends ``stop`` again on every late credit,
and its compute and sink nodes count stops rather than the distinct
upstreams that stopped, so a node with an upstream that never sends
could complete on another upstream's repeated stops.  The port's source
stops once, and a node completes when every distinct upstream stopped.

≙ distributed/fleet_executor/ (SURVEY §2.3): Carrier (carrier.{h,cc}) routes
InterceptorMessages between interceptors — Source/Compute/Amplifier/Sink
(compute_interceptor.cc, source_interceptor.cc, amplifier_interceptor.cc) —
described by TaskNodes (task_node.cc) over a brpc MessageBus
(message_bus.{h,cc}); used for heterogeneous pipeline training/inference.

The rebuild: the same actor contract on host threads + Channels; the MessageBus
carries cross-carrier messages over the framework's TCP framing, so a task
graph can span launcher processes.  The credit-based flow control
(up/downstream buffer counts in compute_interceptor.cc) is kept: a compute
node only fires when every upstream has data and every downstream has
credit.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional

from paddlebox_tpu_torch.utils.channel import Channel, ChannelClosed


@dataclasses.dataclass
class Message:
    src: int
    dst: int
    kind: str           # "data" | "credit" | "stop"
    payload: Any = None
    scope: int = 0      # microbatch / scope id


@dataclasses.dataclass
class TaskNode:
    task_id: int
    role: str                       # source | compute | amplifier | sink
    upstream: List[int] = dataclasses.field(default_factory=list)
    downstream: List[int] = dataclasses.field(default_factory=list)
    fn: Optional[Callable] = None   # compute payload transform
    max_runs: int = -1              # source: number of scopes to emit
    amplify: int = 1                # amplifier fan-out per input
    buffer_size: int = 2            # credits granted to each upstream


class Interceptor:
    def __init__(self, node: TaskNode, carrier: "Carrier"):
        self.node = node
        self.carrier = carrier

    def send(self, dst: int, kind: str, payload=None, scope=0):
        self.carrier.enqueue(Message(self.node.task_id, dst, kind, payload,
                                     scope))

    def handle(self, msg: Message) -> None:
        raise NotImplementedError

    def start(self) -> None:
        pass


class SourceInterceptor(Interceptor):
    """Emits max_runs scopes downstream, honoring downstream credit."""

    def __init__(self, node, carrier, generator: Callable[[int], Any]):
        super().__init__(node, carrier)
        self.generator = generator
        self.credits: Dict[int, int] = {d: 0 for d in node.downstream}
        self.emitted = 0
        self._stop_sent = False

    def start(self):
        self._pump()

    def _pump(self):
        while (self.emitted < self.node.max_runs
               and all(c > 0 for c in self.credits.values())):
            payload = self.generator(self.emitted)
            for d in self.node.downstream:
                self.credits[d] -= 1
                self.send(d, "data", payload, scope=self.emitted)
            self.emitted += 1
        if self.emitted >= self.node.max_runs and not self._stop_sent:
            self._stop_sent = True
            for d in self.node.downstream:
                self.send(d, "stop")

    def handle(self, msg: Message):
        if msg.kind == "credit":
            self.credits[msg.src] = self.credits.get(msg.src, 0) + 1
            self._pump()


class ComputeInterceptor(Interceptor):
    """Fires fn when all upstreams delivered the scope and downstreams have
    credit (compute_interceptor.cc IsInputReady/CanWriteOutput)."""

    def __init__(self, node, carrier):
        super().__init__(node, carrier)
        self.inbox: Dict[int, Dict[int, Any]] = {}   # scope → src → payload
        self.credits: Dict[int, int] = {d: node.buffer_size
                                        for d in node.downstream}
        self.stopped: set = set()     # the upstreams that sent stop
        self._stop_sent = False

    def start(self):
        for u in self.node.upstream:
            for _ in range(self.node.buffer_size):
                self.send(u, "credit")

    def _try_fire(self):
        ready = [s for s, m in sorted(self.inbox.items())
                 if len(m) == len(self.node.upstream)]
        for scope in ready:
            if not all(c > 0 for c in self.credits.values()):
                return
            inputs = self.inbox.pop(scope)
            args = [inputs[u] for u in self.node.upstream]
            out = self.node.fn(*args) if self.node.fn else \
                (args[0] if args else None)
            outs = [out] * self.node.amplify if \
                self.node.role == "amplifier" else [out]
            for o in outs:
                for d in self.node.downstream:
                    self.credits[d] -= 1
                    self.send(d, "data", o, scope)
            for u in self.node.upstream:
                self.send(u, "credit")

    def _maybe_forward_stop(self):
        # forward stop only once every pending scope has drained (a late
        # credit can still fire blocked scopes after upstream stop)
        if (not self._stop_sent
                and self.stopped >= set(self.node.upstream)
                and not self.inbox):
            self._stop_sent = True
            for d in self.node.downstream:
                self.send(d, "stop")

    def handle(self, msg: Message):
        if msg.kind == "data":
            self.inbox.setdefault(msg.scope, {})[msg.src] = msg.payload
            self._try_fire()
        elif msg.kind == "credit":
            self.credits[msg.src] = self.credits.get(msg.src, 0) + 1
            self._try_fire()
        elif msg.kind == "stop":
            self.stopped.add(msg.src)
            self._try_fire()
        self._maybe_forward_stop()


class SinkInterceptor(Interceptor):
    def __init__(self, node, carrier):
        super().__init__(node, carrier)
        self.results: List[Any] = []
        self.stopped: set = set()     # the upstreams that sent stop

    def start(self):
        for u in self.node.upstream:
            for _ in range(self.node.buffer_size):
                self.send(u, "credit")

    def handle(self, msg: Message):
        if msg.kind == "data":
            self.results.append((msg.scope, msg.payload))
            self.send(msg.src, "credit")
        elif msg.kind == "stop":
            self.stopped.add(msg.src)
            if self.stopped >= set(self.node.upstream):
                self.carrier.signal_done()


class MessageBus:
    """Routes messages between carriers (≙ message_bus.{h,cc}).  In-process
    registry; remote carriers can be attached with a PSClient-style sender."""

    def __init__(self):
        self._carriers: Dict[int, "Carrier"] = {}
        self._remote: Dict[int, Callable[[Message], None]] = {}

    def register(self, rank: int, carrier: "Carrier"):
        self._carriers[rank] = carrier

    def register_remote(self, rank: int, sender: Callable[[Message], None]):
        self._remote[rank] = sender

    def deliver(self, rank: int, msg: Message):
        if rank in self._carriers:
            self._carriers[rank].enqueue(msg)
        elif rank in self._remote:
            self._remote[rank](msg)
        else:
            raise KeyError(f"no carrier for rank {rank}")


class Carrier:
    """Owns this rank's interceptors + the dispatch thread (carrier.cc)."""

    def __init__(self, rank: int = 0, bus: Optional[MessageBus] = None,
                 task_rank: Optional[Dict[int, int]] = None):
        self.rank = rank
        self.bus = bus or MessageBus()
        self.bus.register(rank, self)
        self.task_rank = task_rank or {}
        self.interceptors: Dict[int, Interceptor] = {}
        self._inbox = Channel()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add(self, interceptor: Interceptor):
        self.interceptors[interceptor.node.task_id] = interceptor

    def enqueue(self, msg: Message):
        dst_rank = self.task_rank.get(msg.dst, self.rank)
        if dst_rank != self.rank:
            self.bus.deliver(dst_rank, msg)
        else:
            self._inbox.put(msg)

    def signal_done(self):
        self._done.set()
        self._inbox.close()

    def run(self, timeout: float = 60.0):
        def loop():
            while True:
                try:
                    msg = self._inbox.get()
                except ChannelClosed:
                    return
                it = self.interceptors.get(msg.dst)
                if it is not None:
                    it.handle(msg)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        for it in self.interceptors.values():
            it.start()

    def wait(self, timeout: float = 60.0) -> bool:
        ok = self._done.wait(timeout)
        if self._thread is not None:
            self._thread.join(timeout=5)
        return ok


class FleetExecutor:
    """Builds the carrier from TaskNodes and runs the DAG
    (fleet_executor.cc RuntimeGraph → Carrier)."""

    def __init__(self, nodes: List[TaskNode],
                 source_generator: Callable[[int], Any]):
        self.carrier = Carrier()
        self.sinks: List[SinkInterceptor] = []
        for node in nodes:
            if node.role == "source":
                it = SourceInterceptor(node, self.carrier, source_generator)
            elif node.role == "sink":
                it = SinkInterceptor(node, self.carrier)
                self.sinks.append(it)
            else:
                it = ComputeInterceptor(node, self.carrier)
            self.carrier.add(it)

    def run(self, timeout: float = 60.0) -> List[Any]:
        self.carrier.run()
        if not self.carrier.wait(timeout):
            raise TimeoutError("fleet executor DAG did not complete")
        out = []
        for s in self.sinks:
            out.extend(p for _, p in sorted(s.results))
        return out

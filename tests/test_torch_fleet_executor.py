"""The fleet executor in both packages (ports
``tests/test_fleet_executor.py``): the port's module is a copy with its
imports rewritten, so the JAX tests' four DAGs run on each package and
give the same results."""

import importlib

import pytest

PACKAGES = ("paddlebox_tpu", "paddlebox_tpu_torch")


@pytest.fixture(params=PACKAGES)
def fe(request):
    return importlib.import_module(f"{request.param}.runtime.fleet_executor")


def _run(fe, nodes):
    return fe.FleetExecutor(nodes, source_generator=lambda i: i).run()


def test_linear_pipeline_dag(fe):
    nodes = [
        fe.TaskNode(0, "source", downstream=[1], max_runs=10),
        fe.TaskNode(1, "compute", upstream=[0], downstream=[2],
                    fn=lambda x: x * 2),
        fe.TaskNode(2, "compute", upstream=[1], downstream=[3],
                    fn=lambda x: x + 1),
        fe.TaskNode(3, "sink", upstream=[2]),
    ]
    assert _run(fe, nodes) == [i * 2 + 1 for i in range(10)]


def test_diamond_dag_joins_inputs(fe):
    nodes = [
        fe.TaskNode(0, "source", downstream=[1, 2], max_runs=6),
        fe.TaskNode(1, "compute", upstream=[0], downstream=[3],
                    fn=lambda x: x * 10),
        fe.TaskNode(2, "compute", upstream=[0], downstream=[3],
                    fn=lambda x: x + 3),
        fe.TaskNode(3, "compute", upstream=[1, 2], downstream=[4],
                    fn=lambda a, b: a + b),
        fe.TaskNode(4, "sink", upstream=[3]),
    ]
    assert _run(fe, nodes) == [i * 10 + i + 3 for i in range(6)]


def test_amplifier_fans_out(fe):
    nodes = [
        fe.TaskNode(0, "source", downstream=[1], max_runs=3),
        fe.TaskNode(1, "amplifier", upstream=[0], downstream=[2],
                    amplify=2, buffer_size=8),
        fe.TaskNode(2, "sink", upstream=[1], buffer_size=8),
    ]
    assert sorted(_run(fe, nodes)) == [0, 0, 1, 1, 2, 2]


def test_cross_carrier_bus(fe):
    """Two carriers on one bus, tasks split across them."""
    bus = fe.MessageBus()
    task_rank = {0: 0, 1: 1, 2: 0}
    c0 = fe.Carrier(rank=0, bus=bus, task_rank=task_rank)
    c1 = fe.Carrier(rank=1, bus=bus, task_rank=task_rank)
    n0 = fe.TaskNode(0, "source", downstream=[1], max_runs=5)
    n1 = fe.TaskNode(1, "compute", upstream=[0], downstream=[2],
                     fn=lambda x: x ** 2)
    n2 = fe.TaskNode(2, "sink", upstream=[1])
    c0.add(fe.SourceInterceptor(n0, c0, lambda i: i))
    c1.add(fe.ComputeInterceptor(n1, c1))
    sink = fe.SinkInterceptor(n2, c0)
    c0.add(sink)
    c1.run()
    c0.run()
    assert c0.wait(30)
    assert [p for _, p in sorted(sink.results)] == [0, 1, 4, 9, 16]
    with pytest.raises(KeyError, match="no carrier"):
        bus.deliver(7, fe.Message(0, 1, "data"))


def test_port_runtime_exports_and_timeout():
    from paddlebox_tpu_torch import runtime
    for name in ("Carrier", "ComputeInterceptor", "FleetExecutor",
                 "Interceptor", "Message", "MessageBus", "SinkInterceptor",
                 "SourceInterceptor", "TaskNode"):
        assert hasattr(runtime, name)
    # a compute node waiting on an upstream that never sends: run raises
    nodes = [runtime.TaskNode(0, "source", downstream=[1], max_runs=2),
             runtime.TaskNode(1, "compute", upstream=[0, 9],
                              downstream=[2]),
             runtime.TaskNode(2, "sink", upstream=[1])]
    with pytest.raises(TimeoutError):
        runtime.FleetExecutor(nodes, lambda i: i).run(timeout=0.5)


def test_sink_waits_for_every_distinct_upstream():
    """A sink with upstreams [source, 5], where node 5 never sends, times
    out: the port's source sends one stop however many credits come back
    late, and a node completes only once each distinct upstream stopped
    (the reference counted the source's repeated stops instead)."""
    from paddlebox_tpu_torch.runtime import fleet_executor as fe
    nodes = [fe.TaskNode(0, "source", downstream=[1], max_runs=3),
             fe.TaskNode(1, "sink", upstream=[0, 5])]
    ex = fe.FleetExecutor(nodes, lambda i: i)
    with pytest.raises(TimeoutError):
        ex.run(timeout=0.5)
    sink = ex.sinks[0]
    assert sink.stopped == {0}
    assert [p for _, p in sorted(sink.results)] == [0, 1, 2]

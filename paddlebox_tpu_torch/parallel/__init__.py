"""Parallel runtime of the port: topologies and ZeRO sharding over
logical shards (``topology``, ``sharding``), the named-axis collectives
and the trainer fleet's host collective (``collective``).

``HybridTopology`` is exported lazily, so that importing the torch-free
host collective does not import torch."""


def __getattr__(name):
    if name == "HybridTopology":
        from paddlebox_tpu_torch.parallel.topology import HybridTopology
        return HybridTopology
    raise AttributeError(name)

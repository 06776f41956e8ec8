"""Parallel runtime of the port: topologies and ZeRO sharding over
logical shards (``topology``, ``sharding``), the named-axis collectives
and the trainer fleet's host collective (``collective``), and the
parallel layer library over them: tensor-parallel layers
(``tp_layers``), mixture-of-experts (``moe``), pipelines (``pipeline``),
ring and Ulysses attention (``ring_attention``, ``ulysses``).

The torch names are exported lazily, so that importing the torch-free
host collective does not import torch (``ring_attention`` is reached as
its module's function: the name is the module's)."""

import importlib

_LAZY = {
    "HybridTopology": "topology",
    "ColumnParallelLinear": "tp_layers", "RowParallelLinear": "tp_layers",
    "VocabParallelEmbedding": "tp_layers",
    "parallel_cross_entropy": "tp_layers", "load_jax_params": "tp_layers",
    "MoEConfig": "moe", "MoELayer": "moe", "top1_gate": "moe",
    "top2_gate": "moe",
    "PipelineRunner": "pipeline", "PipelineRunner1F1B": "pipeline",
    "HeteroPipeline1F1B": "pipeline", "stack_stage_params": "pipeline",
    "segment_layers": "pipeline",
    "reference_attention": "ring_attention",
    "ulysses_attention": "ulysses",
}


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(
            f"paddlebox_tpu_torch.parallel.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(name)

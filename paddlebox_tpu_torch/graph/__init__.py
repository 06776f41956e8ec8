"""Graph-learning mode: the device graph table, its samplers and walks."""

from paddlebox_tpu_torch.graph.graph_table import GraphTable  # noqa: F401

"""One dense net a file, found by the configuration's ``model`` name.

Each module gives ``param_specs(cfg)`` (the leaves by the program's
parameter names, with their shapes and how the benchmark draws them),
``logits(params, pooled, dense)`` and ``macs_per_record(cfg)`` (the
multiply-adds of the net's matrix products for one record)."""

"""Device ms a step in the sparse rule: the ``device_s`` of the
``ps.optimizer.apply_push`` spans that are children of a
``trainer.step.push`` span, summed, over the stretch's steps (the rule
runs over every working-set row on mxu)."""

from portbench import harness


def read(run):
    sp = harness.load_module("metrics", "sparse_pull_ms_per_step")
    found = sp.rules_under_pushes(run)
    if found is None:
        return None
    pushes, rules = found
    t = sp.device_seconds(rules)
    return 1e3 * sum(t) / len(pushes) if t else None

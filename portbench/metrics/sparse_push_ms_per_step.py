"""Device ms a step in the sparse push less its rule: each
``trainer.step.push`` span's ``device_s`` less that of its own
``ps.optimizer.apply_push`` children, averaged over the stretch's steps
(on mxu the payload, the crossing, the sorted scatter and the
accumulators)."""

from portbench import harness


def read(run):
    sp = harness.load_module("metrics", "sparse_pull_ms_per_step")
    found = sp.rules_under_pushes(run)
    if found is None:
        return None
    pushes, rules = found
    push_s = sp.device_seconds(pushes)
    rule_s = sp.device_seconds(rules)
    if push_s is None or rule_s is None:
        return None
    child = {}
    for r, t in zip(rules, rule_s):
        child[r["parent_id"]] = child.get(r["parent_id"], 0.0) + t
    own = [t - child.get(p["span_id"], 0.0) for p, t in zip(pushes, push_s)]
    return 1e3 * sum(own) / len(own)

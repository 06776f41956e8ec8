"""The sparse rule's useful share of its rows: 100 x the mean distinct
rows a batch pushes (the feed's plans, ``run.shapes["distinct"]``) over
the mean ``rows`` of the stretch's ``ps.optimizer.apply_push`` spans
under a push (the rows the rule ran over)."""

from portbench import harness


def read(run):
    distinct = run.shapes.get("distinct")
    sp = harness.load_module("metrics", "sparse_pull_ms_per_step")
    found = sp.rules_under_pushes(run)
    if not distinct or found is None:
        return None
    rows = [r.get("attrs", {}).get("rows") for r in found[1]]
    if any(not n for n in rows):
        return None
    return 100.0 * (sum(distinct) / len(distinct)) / (sum(rows) / len(rows))

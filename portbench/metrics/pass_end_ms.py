"""Host ms of a pass's end: the mean ``dur_s`` of the port's
``trainer.pass_end`` spans, one a traced pass (the losses' and the AUC
buckets' read-back, which waits for the device, then the AUC on the
host)."""

from portbench import harness


def read(run):
    found = harness.load_module("metrics", "sparse_pull_ms_per_step").spans(
        run, "trainer.pass_end", per="passes")
    if found is None or any(s.get("dur_s") is None for s in found):
        return None
    return 1e3 * sum(s["dur_s"] for s in found) / len(found)

"""Device ms a step in the sparse pull: the mean ``device_s`` of the
port's ``trainer.step.pull`` spans over the traced stretch (on mxu the
pull table's rebuild, the sorted gather, the crossing, seqpool + CVM).

The other readers of the port's spans share the helpers here.  Each
span reader gives None when the run is untraced, when its spans are not
one a step (or a pass), as after a ring overflow, or when a span lacks
its device time."""

PULL = "trainer.step.pull"
PUSH = "trainer.step.push"
RULE = "ps.optimizer.apply_push"


def spans(run, name, per="steps"):
    """The stretch's spans named ``name``, or None unless there is one
    for each of the stretch's ``per`` (``steps`` or ``passes``)."""
    if run.stretch is None:
        return None
    found = [s for s in run.stretch.get("spans", ()) if s["name"] == name]
    return found if found and len(found) == run.stretch[per] else None


def device_seconds(found):
    """Each span's ``device_s``, or None if any lacks one."""
    if found is None:
        return None
    t = [s.get("device_s") for s in found]
    return None if any(x is None for x in t) else t


def mean_device_ms(run, name):
    t = device_seconds(spans(run, name))
    return 1e3 * sum(t) / len(t) if t else None


def rules_under_pushes(run):
    """(the push spans, the rule spans that are their children), or
    None when the pushes are not one a step or no rule span is a push's
    child (a lowering with the rule fused into its push)."""
    pushes = spans(run, PUSH)
    if pushes is None:
        return None
    ids = {s["span_id"] for s in pushes}
    rules = [s for s in run.stretch["spans"]
             if s["name"] == RULE and s["parent_id"] in ids]
    return (pushes, rules) if rules else None


def read(run):
    return mean_device_ms(run, PULL)

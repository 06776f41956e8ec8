"""The traced stretch's share in which the device idles inside a pass's
end: 100 x the stretch's device-idle gaps (``trace_view.gaps`` over its
kernels, copies and memsets) intersected with the ``trainer.pass_end``
ranges of its host thread, on the trace's own clock, over the
stretch's length."""

from portbench.trace_view import gaps

PASS_END = "trainer.pass_end"


def overlap(a, b):
    """Length of the intersection of two lists of disjoint intervals."""
    return sum(max(0.0, min(e, f) - max(s, t)) for s, e in a for t, f in b)


def read(run):
    if run.stretch is None:
        return None
    view = run.stretch["view"]
    ends = [(s, t) for n, s, t in view.host if n == PASS_END]
    if not ends or len(ends) != run.stretch["passes"]:
        return None
    idle = gaps([(s, t) for _, s, t in view.device], view.lo, view.hi)
    return 100.0 * overlap(idle, ends) * 1e-6 / view.window_s

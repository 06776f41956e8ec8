"""The port's own host seconds a step spends dispatching
(``trainer.step_dispatch_s`` observations), their mean over the traced
run's window, in ms.  The window runs without the profiler, whose
per-operation hooks would count in every dispatch; the mean over the
profiled stretch is in the run's notes (``stretch_dispatch_ms``)."""

KEY = "trainer.step_dispatch_s"


def read(run):
    if run.stretch is None:
        return None
    count, total = run.window["stats"].get(KEY, (0.0, 0.0))
    return 1e3 * total / count if count > 0 else None

"""The traced stretch's share in which no kernel, copy or memset ran on
the device: 100 x (1 - their union over the stretch's length)."""


def read(run):
    if run.stretch is None:
        return None
    view = run.stretch["view"]
    return 100.0 * (1.0 - view.busy_s / view.window_s)

"""The 95th percentile, over every step of the window, of the device
interval between the CUDA events recorded after consecutive steps (the
first from an event at the window's start)."""

from portbench.quantiles import percentile


def read(run):
    ms = run.window["step_ms"]
    return percentile(ms, 95) if ms else None

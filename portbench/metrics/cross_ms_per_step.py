"""Device ms a step in the cross network: the mean ``device_s`` of the
port's ``model.dcn.cross`` spans (its forward) plus that of its
``model.dcn.cross.backward`` spans, over the traced stretch.  None in a
cell whose model has no cross network."""

from portbench import harness

CROSS = "model.dcn.cross"
BACKWARD = "model.dcn.cross.backward"


def read(run):
    sp = harness.load_module("metrics", "sparse_pull_ms_per_step")
    fwd, bwd = sp.mean_device_ms(run, CROSS), sp.mean_device_ms(run, BACKWARD)
    if fwd is None or bwd is None:
        return None
    return fwd + bwd

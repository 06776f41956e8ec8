"""Device ms a step in the dense half: the mean ``device_s`` of the
port's ``trainer.step.dense`` spans over the traced stretch (the dense
net's forward and backward, Adam and the AUC's accumulation)."""

from portbench import harness

DENSE = "trainer.step.dense"


def read(run):
    return harness.load_module(
        "metrics", "sparse_pull_ms_per_step").mean_device_ms(run, DENSE)

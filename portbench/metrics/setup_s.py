"""Set-up seconds: from the process's first line to the window's start
(records, the engine lifecycle, the trainer, the feed, the first pass;
the check's state copies left out)."""


def read(run):
    return run.setup_s

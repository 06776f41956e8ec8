"""Records trained in the window over the window's seconds, from the
host clock at its start to the synchronize after its last step."""


def read(run):
    w = run.window
    return w["records"] / w["seconds"] if w["seconds"] > 0 else None

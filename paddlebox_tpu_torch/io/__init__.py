"""Filesystems and checkpoints (host only; the checkpoint's dense half is
``torch.save``)."""

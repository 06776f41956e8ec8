"""The plain reference of a training cell: plain PyTorch and NumPy,
float32, importing nothing of the program under test.

``steps.follow`` trains the first steps of a pass from the records the
benchmark made and the dense weights it drew; ``sparse`` holds the
sparse table in key space (its fresh rows, the pull, seqpool and CVM, the
merged push and the adagrad rule); ``models/<name>.py`` holds each dense
net; ``compare`` turns two trajectories into the numbers that decide
``correct``."""

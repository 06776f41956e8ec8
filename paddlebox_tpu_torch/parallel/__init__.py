"""Host-side parallel runtime of the port: the trainer fleet's
collective (``parallel/collective.py``).  The named-axis collectives and
topologies of the JAX package's ``parallel/`` are not ported yet."""

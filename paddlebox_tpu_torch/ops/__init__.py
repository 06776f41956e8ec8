"""Device ops: the sorted-SpMM pull/push and their Hopper kernels."""

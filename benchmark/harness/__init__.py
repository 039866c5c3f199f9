"""The general harness of the port's benchmark: cells found by name, the
two traffic generators, the trace arithmetic and the correctness check."""

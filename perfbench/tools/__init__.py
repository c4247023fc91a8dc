"""Tools that measure the benchmark itself on the card: a series of runs of
one cell and the calibration of its comparison's limits."""

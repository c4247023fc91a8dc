"""The harness's shared pieces: spec loading, weights, traffic replay support,
the frozen yardstick (peaks, FLOP and byte counts), statistics and the trace
reduction."""

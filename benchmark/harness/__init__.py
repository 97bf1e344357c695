"""The general parts of the benchmark: loading a cell by its names, the
seeded inputs and weights, the serving and training loops, the trace
reader and the result line."""

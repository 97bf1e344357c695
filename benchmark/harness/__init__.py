"""The general parts of the benchmark: loading a cell and what its names
find, the seeded inputs and weights, one loop per traffic kind
(`serve.py`, `train.py`, `offline.py`), the trace reader and the
comparison."""

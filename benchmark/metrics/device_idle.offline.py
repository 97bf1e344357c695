"""As `device_idle.serve`, over the traced offline calls: each call
ends in the copy of its output to the host."""

from benchmark.harness.cell import reader

read = reader("device_idle.serve")

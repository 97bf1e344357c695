"""As `device_idle.serve`, over the traced training steps."""

from benchmark.harness.cell import reader

read = reader("device_idle.serve")

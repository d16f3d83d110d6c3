"""`device.idle` of a cell whose calls are host-bound: it moves that cell's
`rows_per_s.host_bound`."""

from benchmark import harness

read = harness.load_file_module("metrics", "device.idle").read

"""`engine.transform_ms` of the host-bound cell: it moves that cell's
`rows_per_s.host_bound`."""

from benchmark import harness

read = harness.load_file_module("metrics", "engine.transform_ms").read

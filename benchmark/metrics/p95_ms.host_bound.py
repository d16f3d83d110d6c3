"""`p95_ms` of a cell whose calls are host-bound, kept apart for the reason
`rows_per_s.host_bound` gives."""

from benchmark import harness

read = harness.load_file_module("metrics", "p95_ms").read

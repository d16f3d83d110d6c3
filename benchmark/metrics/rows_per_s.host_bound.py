"""`rows_per_s` of a cell whose calls are host-bound.  The host's speed
varies from process to process on a shared machine, so such a cell spreads
several times wider than the cells the card bounds; it has a metric and a
bound of its own, so that theirs can stay tight."""

from benchmark import harness

read = harness.load_file_module("metrics", "rows_per_s").read

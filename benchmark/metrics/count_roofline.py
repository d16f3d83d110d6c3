"""The share of the card's memory roofline of the sorts that `auto` sends
to the `count` engine (carrier transform, K1-K4), in %: as `sort_roofline`
(the bytes the sorts need over the device's busy time in their `sort`
spans), for the host-bound cell whose sorts run there."""

from benchmark import harness

read = harness.load_file_module("metrics", "sort_roofline").read

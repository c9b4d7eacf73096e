"""`compact_ms` in the BVH route's cells, where it moves `rays_per_s.grid`."""

from ptbench import harness

read = harness.load_module("metrics", "compact_ms").read

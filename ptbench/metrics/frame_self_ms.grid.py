"""`frame_self_ms` in the grid route's cells, where it moves `rays_per_s.grid`."""

from ptbench import harness

read = harness.load_module("metrics", "frame_self_ms").read

"""`device_idle_pct` in the grid route's cells, where it moves `rays_per_s.grid`."""

from ptbench import harness

read = harness.load_module("metrics", "device_idle_pct").read

"""`rays_per_s` in the grid route's cells (config 5 on one card and on
four), whose host-bound frames spread from run to run far more than the
cluster route's; BENCHMARK.json holds them to a bound of their own."""

from ptbench import harness

read = harness.load_module("metrics", "rays_per_s").read

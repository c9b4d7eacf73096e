"""`rays_per_s` in the fit cell, whose steps swing with the host's pace
three to four times as far as the render frames do; BENCHMARK.json holds
them to a bound of their own."""

from ptbench import harness

read = harness.load_module("metrics", "rays_per_s").read

"""The roofline's work count reads only a query's rays, answers and the
scene: two routes that answer the same rays alike count the same."""

import torch

from ptbench import work

from pathtracer_tpu_torch.accel.auto import prepare_accel
from pathtracer_tpu_torch.accel.build import with_bvh
from pathtracer_tpu_torch.config import PRESETS
from pathtracer_tpu_torch.engine import intersect
from pathtracer_tpu_torch.ops.intersect_cluster import closest_hit_cluster
from pathtracer_tpu_torch.scene.builder import build_scene


def rays(n, seed):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=g) * 0.8 + 0.1
    d = torch.randn((n, 3), generator=g)
    return o, d / d.norm(dim=1, keepdim=True)


def test_same_count_for_cluster_and_brute_routes():
    torch.set_num_threads(4)
    cfg = PRESETS["bench"]
    scene = prepare_accel(with_bvh(build_scene(cfg.scene)), cfg)
    g = scene.geometry
    o, d = rays(512, 0)
    t_max = torch.full((512,), 1e8)
    t_max[::3] = 0.3            # shadow-like bounds
    t_max[::7] = work.T_MIN     # dead lanes
    t_c, _, _ = closest_hit_cluster(g, o, d, t_max=t_max)
    t_b, _, _ = intersect.brute(g, o, d)
    hit_c = torch.where(t_c < t_max, t_c, 1e8)
    hit_b = torch.where(t_b < t_max, t_b, 1e8)
    assert torch.allclose(hit_c, hit_b, rtol=4e-3, atol=2e-4)
    a = work.query_work(g, o, d, t_max, t_c)
    b = work.query_work(g, o, d, t_max, t_b)
    assert a == b
    assert a["tests"] > 0 and work.bound_ms(a) > 0


def test_count_grows_with_the_segment():
    cfg = PRESETS["bench"]
    g = prepare_accel(with_bvh(build_scene(cfg.scene)), cfg).geometry
    o, d = rays(256, 1)
    short = work.query_work(g, o, d, None, torch.full((256,), 0.05))
    long = work.query_work(g, o, d, None, torch.full((256,), 5.0))
    assert 0 < short["tests"] < long["tests"]


def test_sample_scales_to_every_live_ray(monkeypatch):
    cfg = PRESETS["bench"]
    g = prepare_accel(with_bvh(build_scene(cfg.scene)), cfg).geometry
    o, d = rays(64, 2)
    o, d = o.repeat(8, 1), d.repeat(8, 1)
    t = torch.full((512,), 1e8)
    whole = work.query_work(g, o, d, None, t)
    monkeypatch.setattr(work, "SAMPLE_RAYS", 64)
    part = work.query_work(g, o, d, None, t)
    assert abs(part["tests"] - whole["tests"]) <= 0.25 * whole["tests"]

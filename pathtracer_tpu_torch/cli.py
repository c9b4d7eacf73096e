"""Command-line interface (the reference's ``cli.py``).

Headless front end: render to PNG/npy, resume long renders from
accumulator checkpoints, fit materials to a target image (inverse
rendering), and bench. Every subcommand runs on the card unless given
``--device cpu``; without a CUDA device, ``--device cuda`` (the default)
exits with an error.

    python -m pathtracer_tpu_torch.cli render --preset config3 --out img.png
    python -m pathtracer_tpu_torch.cli render --width 512 --spp 256 \
        --checkpoint ck.npz --checkpoint-every 64
    python -m pathtracer_tpu_torch.cli fit --target target.npy --steps 100
    python -m pathtracer_tpu_torch.cli bench --budget 30 --grad
    python -m pathtracer_tpu_torch.cli render --device cpu --width 64 ...
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

BACKENDS = ["jnp", "pallas", "cluster", "stream", "grid"]


def _add_cfg_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default=None,
                   choices=["config1", "config2", "config3", "config4",
                            "config5", "bench"])
    p.add_argument("--scene", default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--backend", default=None, choices=BACKENDS)
    p.add_argument("--compact", action="store_true")
    p.add_argument("--no-bvh", action="store_true")
    p.add_argument("--config-json", default=None,
                   help="path to a RenderConfig JSON (configs/*.json)")
    # Camera overrides: a new camera is a new render, so accumulation
    # restarts with it.
    p.add_argument("--cam-pos", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--cam-look", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--cam-fov", type=float, default=None,
                   help="vertical field of view in degrees")


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; "
                   "'cpu' runs the kernels' plain versions)")


def _build_cfg(args):
    from .config import PRESETS, RenderConfig

    if args.config_json:
        with open(args.config_json) as f:
            cfg = RenderConfig(**json.load(f))
    elif args.preset:
        cfg = PRESETS[args.preset]
    else:
        cfg = RenderConfig(width=256, height=256, spp=4, max_depth=4,
                           scene="cornell_mesh")
    over = {}
    for field, flag in [("scene", "scene"), ("width", "width"),
                        ("height", "height"), ("spp", "spp"),
                        ("max_depth", "depth"), ("seed", "seed"),
                        ("backend", "backend")]:
        v = getattr(args, flag)
        if v is not None:
            over[field] = v
    if args.compact:
        over["compact"] = True
    if args.no_bvh:
        over["use_bvh"] = False
    return cfg.replace(**over)


def _prepare_scene(cfg, args):
    """The scene with the camera overrides, its BVH and the tables of
    cfg.backend, on args.device."""
    from .accel.auto import prepare_accel
    from .accel.build import with_bvh
    from .scene.builder import build_scene
    from .scene.model import Camera

    scene = build_scene(cfg.scene)
    if args.cam_pos or args.cam_look or args.cam_fov:
        cam = scene.camera

        def vec(v, default):
            if v is None:
                return default
            return torch.tensor(v, dtype=torch.float32)

        fov = (cam.fov_y if args.cam_fov is None else
               torch.tensor(math.radians(args.cam_fov), dtype=torch.float32))
        scene = scene.replace(camera=Camera(
            position=vec(args.cam_pos, cam.position),
            look_at=vec(args.cam_look, cam.look_at),
            up=cam.up, fov_y=fov))
    if cfg.use_bvh:
        scene = with_bvh(scene)
    # Backend-aware table build + large-scene auto-route (accel/auto.py).
    scene = prepare_accel(scene, cfg)
    return scene.to(args.device)


def cmd_render(args) -> int:
    from .engine import wavefront
    from .io import framebuffer as fb

    cfg = _build_cfg(args)
    scene = _prepare_scene(cfg, args)
    t0 = time.time()

    # The accumulator lives on the host in f32, as in the reference, so a
    # resumed render adds its chunks in the same order as a straight one.
    spp_done = 0
    acc = np.zeros((cfg.n_pixels, 3), np.float32)
    if args.resume and os.path.exists(args.resume):
        acc, spp_done, _ = fb.load_accumulator(args.resume)
        acc = acc.reshape(-1, 3).copy()
        print(f"resumed at {spp_done}/{cfg.spp} spp from {args.resume}")

    out = args.out or "render.png"
    # Progressive preview: every --preview-every spp, overwrite
    # <out>.preview.png (or .npy) with the running average. Samples are
    # keyed by absolute spp index, so previews never perturb the final
    # image.
    preview_path = None
    if args.preview_every:
        stem, ext = os.path.splitext(out)
        preview_path = stem + ".preview" + (ext if ext == ".npy" else ".png")

    # Per-feature due thresholds (fire when spp_done reaches the next
    # multiple, then advance it) rather than exact-modulo gates: with
    # e.g. --checkpoint-every 10 --preview-every 3 the loop advances in
    # chunks of 3 and spp_done % 10 == 0 would only fire at multiples of
    # 30. Chunks also shrink to land exactly on the nearest upcoming
    # threshold, so firings stay on their own multiples.
    def _next_due(every, spp_done):
        return ((spp_done // every) + 1) * every if every else None

    next_ckpt = _next_due(args.checkpoint_every, spp_done)
    next_prev = _next_due(args.preview_every, spp_done)
    base_chunk = cfg.spp_chunk or cfg.spp
    while spp_done < cfg.spp:
        n = min(base_chunk, cfg.spp - spp_done)
        for due in (next_ckpt, next_prev):
            if due is not None and due > spp_done:
                n = min(n, due - spp_done)
        part = wavefront.render_accumulate(scene, cfg, spp_start=spp_done,
                                           n_spp=n)
        acc += fb.to_host(part)
        spp_done += n
        done = spp_done >= cfg.spp
        if args.checkpoint and (
            done or not args.checkpoint_every
            or (next_ckpt is not None and spp_done >= next_ckpt)
        ):
            fb.save_accumulator(args.checkpoint, acc, spp_done,
                                {"cfg": cfg.to_json()})
            print(f"checkpointed {spp_done}/{cfg.spp} spp")
            next_ckpt = _next_due(args.checkpoint_every, spp_done)
        if preview_path and (
            done or (next_prev is not None and spp_done >= next_prev)
        ):
            next_prev = _next_due(args.preview_every, spp_done)
            pimg = (acc / spp_done).reshape(cfg.height, cfg.width, 3)
            if preview_path.endswith(".npy"):
                fb.write_npy(preview_path, pimg)
            else:
                fb.write_png(preview_path, pimg)
            print(f"preview {spp_done}/{cfg.spp} spp -> {preview_path} "
                  f"({time.time() - t0:.1f}s)")
    img = (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)
    dt = time.time() - t0
    print(f"rendered {cfg.width}x{cfg.height} {cfg.spp}spp "
          f"depth{cfg.max_depth} in {dt:.2f}s")

    if out.endswith(".npy"):
        fb.write_npy(out, img)
    else:
        fb.write_png(out, img)
    print(f"wrote {out}")
    return 0


def adam(params, lr: float) -> torch.optim.Adam:
    """The optimizer of `fit`: optax.adam's defaults."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def cmd_fit(args) -> int:
    """Inverse rendering: optimize materials to match a target image."""
    from .diff import render as dr
    from .io import framebuffer as fb
    from .scene.model import Materials

    cfg = _build_cfg(args)
    scene = _prepare_scene(cfg, args)
    if args.target:
        target = torch.as_tensor(np.load(args.target), device=args.device)
    else:
        # Self-calibration demo: render the target with true materials,
        # start from a perturbed guess, recover.
        with torch.no_grad():
            target = dr.render_image(scene, cfg, scene.materials)
        print("no --target given: using self-render as target (demo mode)")

    albedo, emission = scene.materials.albedo, scene.materials.emission
    if args.perturb:
        rng = np.random.default_rng(0)
        host = fb.to_host(albedo)
        albedo = torch.from_numpy(np.clip(
            host + rng.normal(0, 0.15, host.shape), 0.05, 0.95
        ).astype(np.float32)).to(args.device)
    params = [albedo.detach().clone().requires_grad_(True),
              emission.detach().clone().requires_grad_(True)]
    opt = adam(params, args.lr)

    def mats():
        return Materials(albedo=params[0].detach(),
                         emission=params[1].detach())

    for step in range(args.steps):
        loss, grads = dr.loss_and_grad(scene, cfg, mats(), target)
        params[0].grad, params[1].grad = grads.albedo, grads.emission
        opt.step()
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.6f}")
        if args.fit_checkpoint and step % 20 == 19:
            np.savez(
                args.fit_checkpoint,
                albedo=fb.to_host(params[0]),
                emission=fb.to_host(params[1]),
                step=step,
            )
    with torch.no_grad():
        img = dr.render_image(scene, cfg, mats())
    if args.out:
        fb.write_png(args.out, img)
        print(f"wrote {args.out}")
    print("final albedo:", fb.to_host(params[0]).round(3).tolist())
    return 0


def cmd_bench(args) -> int:
    """Forward the bench flags to bench_torch.py (one source of truth)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, os.path.join(root, "bench_torch.py")]
    for flag in ("smoke", "compact", "grad"):
        if getattr(args, flag):
            cmd.append(f"--{flag}")
    for flag in ("scene", "width", "height", "depth", "spp", "backend",
                 "budget"):
        v = getattr(args, flag)
        if v is not None:
            cmd += [f"--{flag}", str(v)]
    cmd += ["--device", str(args.device)]
    return subprocess.call(cmd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pathtracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG/npy")
    _add_cfg_flags(pr)
    _add_device_flag(pr)
    pr.add_argument("--out", default=None)
    pr.add_argument("--checkpoint", default=None,
                    help="accumulator checkpoint path (.npz)")
    pr.add_argument("--checkpoint-every", type=int, default=None,
                    help="spp per checkpointed chunk")
    pr.add_argument("--resume", default=None,
                    help="resume from an accumulator checkpoint")
    pr.add_argument("--preview-every", type=int, default=None,
                    help="dump a converging <out>.preview image every N "
                    "spp")
    pr.set_defaults(fn=cmd_render)

    pf = sub.add_parser("fit", help="inverse rendering: fit materials")
    _add_cfg_flags(pf)
    _add_device_flag(pf)
    pf.add_argument("--target", default=None, help=".npy target image")
    pf.add_argument("--steps", type=int, default=50)
    pf.add_argument("--lr", type=float, default=0.03)
    pf.add_argument("--perturb", action="store_true",
                    help="perturb start materials (demo)")
    pf.add_argument("--out", default=None)
    pf.add_argument("--fit-checkpoint", default=None)
    pf.set_defaults(fn=cmd_fit)

    pb = sub.add_parser("bench", help="run the benchmark (bench_torch.py)")
    _add_device_flag(pb)
    pb.add_argument("--smoke", action="store_true")
    pb.add_argument("--scene", default=None)
    pb.add_argument("--width", type=int, default=None)
    pb.add_argument("--height", type=int, default=None)
    pb.add_argument("--depth", type=int, default=None)
    pb.add_argument("--spp", type=int, default=None)
    pb.add_argument("--backend", default=None, choices=BACKENDS)
    pb.add_argument("--budget", type=float, default=None)
    pb.add_argument("--compact", action="store_true")
    pb.add_argument("--grad", action="store_true",
                    help="time value-and-grad steps instead of frames")
    pb.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    from . import _device

    try:
        args.device = _device(args.device)
    except RuntimeError:
        ap.error(f"--device {args.device}: no CUDA device; pass "
                 "--device cpu to run on the CPU")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

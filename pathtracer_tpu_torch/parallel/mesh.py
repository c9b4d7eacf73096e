"""Distributed rendering: pixels sharded over torch.distributed ranks (the
reference's ``parallel/mesh.py``).

The workload is data parallel over rays: each rank of a 1-D mesh traces a
contiguous slice of the image's row-major pixel ids on its own device
with the whole scene replicated, the slices are all-gathered into the
image, and material gradients are all-reduced. The names follow the
reference so each counterpart is easy to find.

Determinism: all sampling keys off absolute pixel ids (sampling/rng.py),
so the sharded render equals the single-process render bit for bit at
fixed seeds, whatever the number of ranks (tests/test_torch_dist.py).

Multi-host use: every process calls `initialize_distributed` (under
``torchrun`` with no arguments), then `make_mesh`; each rank renders on
``cuda:{LOCAL_RANK % device_count}``. Without a process group the mesh
has one rank and its collectives are identities.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..cli import adam
from ..config import RenderConfig
from ..diff.render import render_image, value_and_grad
from ..engine.wavefront import render_accumulate
from ..scene.model import Materials, Scene
from ..utils.profiling import span

AXIS = "rays"


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> None:
    """Join the process group (no-op for one process started without
    torchrun, or when a group already exists).

    With num_processes > 1, the group forms at ``tcp://<coordinator>``
    (host:port) with the given world size and rank. Without flags, under
    torchrun (WORLD_SIZE in the environment), it forms through ``env://``.
    The backend is "nccl" where there is a CUDA device and "gloo"
    otherwise, unless named: ranks that share one card must name "gloo".
    """
    if dist.is_initialized():
        return
    if num_processes is None:
        if "WORLD_SIZE" not in os.environ:
            return
        init, kw = "env://", {}
    elif num_processes <= 1:
        return
    else:
        init = f"tcp://{coordinator}"
        kw = {"world_size": num_processes, "rank": process_id}
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init, **kw)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """1-D mesh over the ray/pixel axis: `size` ranks of the process group
    `group` (None: one rank, no process group), this process's `rank` in
    it and the device it renders on."""

    group: object
    rank: int
    size: int
    device: torch.device

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum x over the ranks, in place; returns x."""
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x concatenated along dim 0, in rank order."""
        if self.group is None:
            return x
        with span("gather"):
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x.contiguous(), group=self.group)
            return torch.cat(parts)

    def shard(self, ids: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous slice of `ids`, on its device."""
        per = ids.shape[0] // self.size
        return ids[self.rank * per:(self.rank + 1) * per].to(self.device)


def _mesh_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "on the CPU")
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def make_mesh(n_devices: int | None = None, device=None) -> Mesh | None:
    """1-D mesh over the first n_devices ranks (default: all).

    `device` defaults to the card; ``"cuda"`` without an index means
    ``cuda:{LOCAL_RANK % device_count}``. It raises without a CUDA
    device. With a process group, this call is collective (every rank
    makes it) and returns None on ranks outside the mesh; without one,
    the mesh has one rank.
    """
    device = _mesh_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"{n_devices} devices asked for, but no "
                             "process group: call initialize_distributed")
        return Mesh(None, 0, 1, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"{n} devices asked for, the group has {world}")
    group = (dist.group.WORLD if n == world
             else dist.new_group(list(range(n))))
    if rank >= n:
        return None
    return Mesh(group, rank, n, device)


def _padded_ids(cfg: RenderConfig, n_shards: int):
    """Row-major pixel ids padded to a multiple of the shard count.

    Padding rays trace pixel 0 redundantly (their radiance is dropped
    after the gather); wasted lanes are < n_shards pixels total. Returns
    (int64 ids on the CPU, pad).
    """
    n = cfg.n_pixels
    pad = (-n) % n_shards
    ids = torch.arange(n + pad, dtype=torch.int64)
    ids[n:] = 0
    return ids, pad


def render_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh | None = None,
                   materials=None) -> torch.Tensor:
    """Full render with pixels sharded over the mesh → the (H, W, 3) image,
    the same on every rank, on the rank's device.

    Each rank traces every spp sample of its slice of the padded ids in
    one accumulation (as `render` does when spp_chunk is 0, 1 or >= spp,
    which it then equals bit for bit).
    """
    if mesh is None:
        mesh = make_mesh()
    ids, _ = _padded_ids(cfg, mesh.size)
    if materials is not None:
        materials = materials.to(mesh.device)
    with torch.inference_mode():
        acc = render_accumulate(scene.to(mesh.device), cfg, materials,
                                pixel_ids=mesh.shard(ids))
        img = mesh.all_gather(acc)[: cfg.n_pixels] / float(cfg.spp)
    return img.reshape(cfg.height, cfg.width, 3)


def _loss_inputs(cfg: RenderConfig, target, mesh: Mesh):
    """This rank's (pixel ids, target rows, loss weights); the weight is 0
    on padding rows."""
    ids, pad = _padded_ids(cfg, mesh.size)
    tgt = torch.as_tensor(target, dtype=torch.float32,
                          device=mesh.device).reshape(-1, 3)
    tgt = torch.cat([tgt, tgt.new_zeros((pad, 3))])
    w = torch.ones((ids.shape[0], 1), dtype=torch.float32)
    w[cfg.n_pixels:] = 0.0
    return mesh.shard(ids), mesh.shard(tgt), mesh.shard(w)


def _loss_and_grad(scene: Scene, cfg: RenderConfig, materials: Materials,
                   inputs, mesh: Mesh):
    ids, tgt, w = inputs
    n_total = cfg.n_pixels * 3

    def loss_fn(mats):
        img = render_image(scene, cfg, mats, pixel_ids=ids)
        # Local sum of squared error; the global mean after the all-reduce.
        return torch.sum(w * (img - tgt) ** 2) / n_total

    loss, grads = value_and_grad(loss_fn, materials)
    # Each rank's grads cover its own pixels only: sum them over the mesh.
    mesh.all_reduce(loss)
    mesh.all_reduce(grads.albedo)
    mesh.all_reduce(grads.emission)
    return loss, grads


def loss_and_grad_sharded(scene: Scene, cfg: RenderConfig,
                          materials: Materials, target,
                          mesh: Mesh | None = None):
    """Sharded forward and backward: the mean squared error of the image
    against `target` ((H, W, 3)) and its grads w.r.t. the materials,
    all-reduced over the mesh. Returns (loss, Materials), the same on
    every rank."""
    if mesh is None:
        mesh = make_mesh()
    return _loss_and_grad(scene.to(mesh.device), cfg,
                          materials.to(mesh.device),
                          _loss_inputs(cfg, target, mesh), mesh)


def make_train_step(scene: Scene, cfg: RenderConfig, target, mesh: Mesh,
                    lr: float = 1e-2):
    """An inverse-rendering training step over the mesh: fit the materials
    so the rendered image matches `target`.

    Forward and backward run sharded over rays, the grads are all-reduced,
    and Adam (optax.adam's defaults, as `cli fit` uses) updates the
    replicated materials; every rank applies the same update to the same
    values, so the materials stay bit-identical across ranks. The
    optimizer state lives in the step.

    Returns step(materials) -> (loss, materials).
    """
    scene = scene.to(mesh.device)
    inputs = _loss_inputs(cfg, target, mesh)
    mats = scene.materials
    params = [x.detach().clone().requires_grad_(True)
              for x in (mats.albedo, mats.emission)]
    opt = adam(params, lr)

    def step(materials: Materials):
        materials = materials.to(mesh.device)
        loss, grads = _loss_and_grad(scene, cfg, materials, inputs, mesh)
        with torch.no_grad():
            params[0].copy_(materials.albedo)
            params[1].copy_(materials.emission)
        params[0].grad, params[1].grad = grads.albedo, grads.emission
        opt.step()
        return loss, Materials(albedo=params[0].detach().clone(),
                               emission=params[1].detach().clone())

    return step

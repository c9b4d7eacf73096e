"""Forward frames of the engine on one card, back to back.

Frame i traces sample i of every pixel (`trace_sample` over the
tile-ordered ids of `tiled_pixel_ids`, as bench_torch.py's loop does) and
ends in a device barrier; its useful rays are the engine's own count. The
check holds `check_pixels` pixels drawn from the
seed, in the first timed frame, one frame drawn from the seed among the
first `check_within` and the last, to the reference's render of the same
pixels and samples: `bad_px_share` is the share of them off by more than
`pixel_atol` + `pixel_rtol` * |reference|.

Params: check_pixels, check_within, trace_frames, pixel_atol, pixel_rtol,
ref_block.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.engine.camera import tiled_pixel_ids

from .. import check, program
from ..flow import single, sync


class Mode:
    def __init__(self, run):
        self.plan(run)
        self.scene, run.scene_build_s = program.build(
            program.render_config(run.config, 0), self.dev,
            lambda: sync(self.dev))

    def plan(self, run) -> None:
        """What the mode needs besides the program's state: the pixel ids."""
        self.run = run
        self.dev = torch.device(run.device)
        cfg = program.render_config(run.config, 0)
        self.ids = tiled_pixel_ids(0, cfg.n_pixels, cfg.width,
                                   device=self.dev)

    def start(self, seed: int) -> None:
        p = self.run.params
        self.seed = seed % (2 ** 31)
        self.cfg = program.render_config(self.run.config, self.seed)
        g = torch.Generator().manual_seed(seed)
        self.rows = torch.randperm(self.ids.shape[0], generator=g)[
            :p["check_pixels"]].to(self.dev)
        mid = 2 + int(torch.randint(max(1, p["check_within"] - 1), (1,),
                                    generator=g))
        self.check_at = {1, mid}
        self.kept = {}
        self.last = None

    def frame(self, i: int) -> int:
        """Frame i (sample i); i = 0 is the untimed warm frame."""
        s = self.scene
        rad, n = wavefront.trace_sample(s.geometry, s.materials, s.camera,
                                        s.lights, self.cfg, self.ids, i,
                                        with_stats=True)
        if i in self.check_at:
            self.kept[i] = rad[self.rows]
        self.last = (i, rad)
        return int(n)

    def outputs(self) -> dict:
        """{sample index: the checked pixels' radiance} of the frames kept."""
        out = dict(self.kept)
        i, rad = self.last
        out[i] = rad[self.rows]
        return out

    def free(self) -> None:
        self.scene = self.last = None

    def numbers(self, outputs: dict, ref) -> dict:
        p = self.run.params
        ids = self.ids[self.rows]
        prog = torch.cat([outputs[i] for i in sorted(outputs)])
        want = torch.cat([ref.pixels(self.seed, i, ids, p["ref_block"])
                          for i in sorted(outputs)])
        return {"bad_px_share": check.bad_share(
            prog.float(), want, p["pixel_atol"], p["pixel_rtol"])}

    def control(self, ref, low) -> dict:
        """The numbers of the reference in lower precision (`low`) put in
        the program's place, over the same samples as a run checks."""
        p = self.run.params
        ids = self.ids[self.rows]
        got = {i: low.pixels(self.seed, i, ids, p["ref_block"])
               for i in sorted(self.check_at | {p["check_within"] + 1})}
        return self.numbers(got, ref)


def main(run, args):
    return single(run, Mode)

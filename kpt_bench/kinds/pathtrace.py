"""The multi-bounce path tracer as a user renders stills or a progressive
preview with it: a closed loop of independent images.

One image at a time through the program's render/wavefront.render_pathtraced
(the configuration's spheres on the floor under the sphere light, `spp`
samples a pixel, `max_depth` bounces), from a fixed camera, each image
synchronized before the next is launched. Image i renders frame
frame_base + i, so each image draws new R2 samples; the seed picks
frame_base and the window's images that the check keeps.

Check: no state passes from image to image, so each kept image is rendered
again by the plain reference (reference/path.py) from its own frame number
and compared with the program's. One flipped sampling decision (a lobe, a
TIR test, a Fresnel roulette) changes a whole path, so the images are
compared by statistics, as the program's tests compare its path kernel with
its plain version: the median |Δ| over the image's components, the share of
components beyond FAR, and the count of non-finite components. The set-up's
first image and the window's last are kept besides those the seed draws.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kpt_bench import harness, scenes
from kpt_bench.kinds import Kind
from kpt_bench.reference import frame as rf
from kpt_bench.reference import path as rp

CHECKS = ("median_abs", "far_share", "nonfinite")
# |Δ| beyond which an image component counts as far (ops/path_kernel.FAR).
FAR = 3e-2


def compare(img: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far an image parts from the reference's: the median |Δ| over its
    components, the share of components beyond FAR, and the number of
    non-finite components of `img`."""
    d = (img.float() - ref.float()).abs()
    return {"median_abs": d.median().item(), "far_share": (d > FAR).float().mean().item(),
            "nonfinite": float((~torch.isfinite(img)).sum().item())}


def scene_tree(spec: dict) -> dict:
    """The configuration's scene as numpy tables: scenes.sphere_scene's
    spheres, floor and light, with the file's floor, light, colour, energies,
    BSDF kinds and iors written in."""
    tree = scenes.sphere_scene(spec["centers"], spec["radii"], spec["albedos"])
    m, ids = tree["materials"], 3 + np.arange(len(spec["radii"]))
    tree["planes"] = np.asarray([spec["floor"]], np.float32)
    tree["spheres"][0] = np.asarray(spec["light"], np.float32)
    tree["light_color"] = np.asarray(spec["light_color"], np.float32)
    m["emission"][scenes.LIGHT] = tree["light_color"]
    m["en_const"][ids] = np.asarray(spec["en_const"], np.float32)
    m["bsdf"][ids] = [rp.KINDS[k] for k in spec["kinds"]]
    m["ior"][ids] = np.asarray(spec["iors"], np.float32)
    return tree


class Loop(Kind):
    @classmethod
    def tiny(cls, cell) -> None:
        cell.traffic.update(warmup_frames=2, check_within=3, check_frames=2)

    def __init__(self, cell, seed: int, device):
        from kylespathtracer_tpu_torch.render import wavefront
        from kylespathtracer_tpu_torch.render.camera import Camera
        from kylespathtracer_tpu_torch.scene.types import scene_from_numpy
        from kylespathtracer_tpu_torch.utils.config import RenderConfig

        tr, conf = cell.traffic, cell.config
        if conf["scene"]["kind"] != "spheres":
            raise ValueError(f"the pathtrace loop renders a sphere scene, not {conf['scene']['kind']!r}")
        self.cell, self.device = cell, torch.device(device)
        self.rc = dict(cell.render, width=int(tr["width"]), height=int(tr["height"]), spp=int(tr["spp"]),
                       max_depth=int(tr["max_depth"]))
        self.tree = scene_tree(conf["scene"])
        self.loc = torch.tensor(conf["camera"]["loc"], dtype=torch.float32, device=self.device)
        self.orient = torch.tensor(conf["camera"]["orient"], dtype=torch.float32, device=self.device)
        self.render = wavefront.render_pathtraced
        self.scene = scene_from_numpy(self.tree, device=self.device)
        self.camera = Camera(loc=self.loc, orient=self.orient)
        rc = self.rc
        self.config = RenderConfig(width=rc["width"], height=rc["height"], spp=rc["spp"], max_depth=rc["max_depth"],
                                   gloss=float(rc["gloss"]), brightness=float(rc["brightness"]),
                                   fov=float(rc["fov"]), path_backend=rc["path_backend"])
        self.frame_base = seed % int(tr["frame_span"])
        rng = np.random.default_rng(seed)
        self.sample = set(rng.choice(int(tr["check_within"]), size=int(tr["check_frames"]), replace=False).tolist())
        self.kept = []  # (image index, the program's image)
        self.tally = {}  # the reference's segments and vertices an image, once checked
        self.i = 0
        t = time.perf_counter()
        for _ in range(int(tr["warmup_frames"])):
            img = self.step()
            if not self.kept:
                self.kept.append((0, img))
        harness.note(f"set-up: {tr['warmup_frames']} warm-up images", t)

    def step(self) -> torch.Tensor:
        """One image, synchronized: frame frame_base + i."""
        img = self.render(self.scene, self.camera, self.config, self.frame_base + self.i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.i += 1
        return img

    def window(self, seconds: float, trace_steps: int) -> dict:
        from kpt_bench import trace as tr_mod

        prof = tr_mod.profiled(self.device) if trace_steps else None
        traced = prof.__enter__() if prof else None
        n = 0
        t0 = time.perf_counter()
        while True:
            i = self.i
            img = self.step()
            if n in self.sample:
                self.kept.append((i, img))
            n += 1
            if prof and n == trace_steps:
                prof.__exit__(None, None, None)
                prof = None
            if time.perf_counter() - t0 >= seconds and prof is None:
                break
        elapsed = time.perf_counter() - t0
        if self.kept[-1][0] != i:
            self.kept.append((i, img))
        out = {"steps": n, "metrics": {"frame_ms": elapsed * 1e3 / n}}
        if traced is not None:
            out.update(traced=traced, traced_steps=trace_steps)
        return out

    def reference(self, i: int, dtype=torch.float32, tally=None, **over) -> torch.Tensor:
        """Image i by the plain reference in `dtype`; `over` replaces render
        knobs (spp, max_depth) or the frame (`frame`)."""
        sc = rf.scene_tables(self.tree, self.device, dtype)
        kinds, iors = rp.material_tables(self.tree, self.device, dtype)
        frame = over.pop("frame", self.frame_base + i)
        return rp.render(sc, kinds, iors, self.loc.to(dtype), self.orient.to(dtype), frame, dict(self.rc, **over),
                         int(self.cell.traffic["block_rows"]), tally)

    def check(self) -> list:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        tally = {}
        rows = [compare(img, self.reference(i, tally=tally)) for i, img in self.kept]
        self.tally = {k: v / len(self.kept) for k, v in tally.items()}
        lim = self.cell.traffic["limits"]
        return [harness.Check(k, max(r[k] for r in rows), float(lim[k])) for k in CHECKS]

    def faults(self) -> dict:
        """The control and the faults (kpt_bench/calibrate.py), each in the
        program's place against the float32 reference, over the kept images:
        the reference in bfloat16; at half the samples; one bounce fewer; the
        frame index ignored (frame 0 every image)."""
        sides = {"control": dict(dtype=torch.bfloat16),
                 "half_samples": dict(spp=max(1, int(self.rc["spp"]) // 2)),
                 "one_bounce_fewer": dict(max_depth=int(self.rc["max_depth"]) - 1),
                 "frame_ignored": dict(frame=0)}
        out = {side: [] for side in sides}
        for i, _ in self.kept:
            ref = self.reference(i)
            for side, over in sides.items():
                out[side].append(compare(self.reference(i, **over), ref))
        return {side: {k: max(r[k] for r in rows) for k in CHECKS} for side, rows in out.items()}

    def facts(self) -> dict:
        px = int(self.rc["width"]) * int(self.rc["height"])
        return {"tree": self.tree, "rc": self.rc, "pixels": px, "spp": int(self.rc["spp"]),
                **self.tally, "per_step": {"k7": 1}}

"""The real-time temporal renderer as a viewer drives it: a closed loop.

One frame at a time through the program's `render/pipeline.render_frame`,
the history carried from frame to frame, each frame's displayed image
synchronized before the next frame is launched. The camera follows the
scripted path (scenes.pose_spline) at `t_per_frame` a frame, which loops
every `loop_frames` frames; the seed picks the start on the loop and the
frame counter that seeds the samples, so every seed renders the same poses
in another order.

Check: each frame compared is recomputed by the plain reference from the
history the program carried into it (the reference follows the program
frame by frame, since the history is the program's state) and compared
with the program's image and new history; the first frame of the set-up
is compared from the empty history, so the start is checked whole.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kpt_bench import harness, roofline, scenes
from kpt_bench.kinds import Kind
from kpt_bench.reference import frame as rf

CHECKS = ("image_far", "history_far", "oid_mismatch")


def _hist_dict(h) -> dict:
    """The program's History as the reference's plain dict."""
    ch = lambda c: {"rgb": c.rgb, "cnt": c.cnt, "oid": c.oid}
    return {"d": ch(h.diffuse), "s": ch(h.specular), "loc": h.camera.loc, "orient": h.camera.orient}


def _far(a: torch.Tensor, b: torch.Tensor, scale_min: float = 1.0) -> torch.Tensor:
    """Components of `a` beyond 1e-3·max(scale_min, |b|) of `b`."""
    return (a.float() - b.float()).abs() > 1e-3 * torch.clamp(b.float().abs(), min=scale_min)


def compare(img, hist: dict, ref_img, ref_hist: dict) -> dict:
    """How far a frame parts from the reference's: the share of image
    components beyond 1e-3, of history components (rgb and count of both
    sets) beyond 1e-3·max(1, |ref|), and of pixels whose object id differs."""
    far_h = [_far(hist[k][f], ref_hist[k][f]).reshape(-1) for k in ("d", "s") for f in ("rgb", "cnt")]
    return {"image_far": _far(img, ref_img).float().mean().item(),
            "history_far": torch.cat(far_h).float().mean().item(),
            "oid_mismatch": (hist["d"]["oid"] != ref_hist["d"]["oid"]).float().mean().item()}


class Loop(Kind):
    @classmethod
    def tiny(cls, cell) -> None:
        cell.traffic.update(warmup_frames=2, check_within=3, check_frames=2)

    def __init__(self, cell, seed: int, device):
        from kylespathtracer_tpu_torch.render.camera import Camera
        from kylespathtracer_tpu_torch.render.pipeline import init_history, render_frame
        from kylespathtracer_tpu_torch.scene.types import scene_from_numpy

        tr, self.rc = cell.traffic, dict(cell.render, width=cell.traffic["width"], height=cell.traffic["height"])
        self.cell, self.device, self.seed = cell, torch.device(device), seed
        if cell.config["scene"]["kind"] != "default":
            raise ValueError(f"the temporal loop renders the default scene, not {cell.config['scene']}")
        self.tree = scenes.default_scene()
        self.render_frame, self.Camera = render_frame, Camera
        self.scene = scene_from_numpy(self.tree, device=self.device)
        self.config = harness.port_config(self.rc)
        loop = int(tr["loop_frames"])
        offset = seed % loop
        self.frame_base = (seed // loop) % int(tr["frame_span"])
        poses = [scenes.pose_spline(float(tr["t_per_frame"]) * ((offset + i) % loop)) for i in range(loop)]
        self.locs = torch.as_tensor(np.stack([p[0] for p in poses]), device=self.device)
        self.ors = torch.as_tensor(np.stack([p[1] for p in poses]), device=self.device)
        self.loop = loop
        rng = np.random.default_rng(seed)
        self.sample = set(rng.choice(int(tr["check_within"]), size=int(tr["check_frames"]), replace=False).tolist())
        self.kept = []  # (window frame, index, prev history, image, new history)
        t = time.perf_counter()
        self.hist = init_history(self.config, self.camera(0))
        self.i = 0
        for _ in range(int(tr["warmup_frames"])):
            prev = self.hist
            img = self.step()
            if len(self.kept) == 0:
                self.kept.append(("start", 0, prev, img, self.hist))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        harness.note(f"set-up: {tr['warmup_frames']} warm-up frames", t)

    def camera(self, i: int):
        return self.Camera(loc=self.locs[i % self.loop], orient=self.ors[i % self.loop])

    def step(self) -> torch.Tensor:
        img, self.hist = self.render_frame(self.scene, self.camera(self.i), self.hist, self.frame_base + self.i,
                                           self.config)
        self.i += 1
        return img

    def window(self, seconds: float, trace_steps: int) -> dict:
        from kpt_bench import trace as tr_mod

        cuda = self.device.type == "cuda"
        marks, host_ms, out, n = [], [], {}, 0
        prof = tr_mod.profiled(self.device) if trace_steps else None
        traced = prof.__enter__() if prof else None
        t0 = time.perf_counter()
        while True:
            prev, i = self.hist, self.i
            if cuda:
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
            h = time.perf_counter()
            img = self.step()
            if cuda:
                e.record()
                e.synchronize()
                marks.append((s, e))
            else:
                host_ms.append((time.perf_counter() - h) * 1e3)
            if n in self.sample:
                self.kept.append((n, i, prev, img, self.hist))
            n += 1
            if prof and n == trace_steps:
                prof.__exit__(None, None, None)
                prof = None
            if time.perf_counter() - t0 >= seconds and prof is None:
                break
        elapsed = time.perf_counter() - t0
        if not any(k[0] == n - 1 for k in self.kept):
            self.kept.append((n - 1, i, prev, img, self.hist))
        # Each frame's own time by the device's clock, from the start event,
        # recorded as the frame's call begins on an idle device, to the end
        # event after its last launch (the host's clock on the CPU); the
        # frames under the profiler left out (metrics/frame_ms_p95.py).
        self.frame_times = ([s.elapsed_time(e) for s, e in marks] or host_ms)[trace_steps:]
        out = {"steps": n, "metrics": {"frame_ms": elapsed * 1e3 / n}}
        if traced is not None:
            out.update(traced=traced, traced_steps=trace_steps)
        return out

    def frames_compared(self, program, dtype=torch.float32) -> list:
        """For each kept frame: the numbers of `compare` between `program`'s
        frame (a function (prev history dict, camera index, frame) → (image,
        history dict)) and the float32 reference's."""
        sc = rf.scene_tables(self.tree, self.device)
        out = []
        for _, i, prev, img, new in self.kept:
            loc, orient = self.locs[i % self.loop], self.ors[i % self.loop]
            ref_img, ref_new = rf.temporal_frame(sc, loc, orient, _hist_dict(prev), self.frame_base + i, self.rc)
            p_img, p_new = program(prev, i, img, new)
            out.append(compare(p_img, p_new, ref_img, ref_new))
            self.shaded = roofline.shaded_pixels(ref_new["d"]["oid"])
        return out

    def check(self) -> list:
        self.hist = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        rows = self.frames_compared(lambda prev, i, img, new: (img, _hist_dict(new)))
        lim = self.cell.traffic["limits"]
        return [harness.Check(k, max(r[k] for r in rows), float(lim[k])) for k in CHECKS]

    def faults(self) -> dict:
        """The control (kpt_bench/calibrate.py): each kept frame from the
        program's previous history by the reference in bfloat16."""
        low = torch.bfloat16
        sc = rf.scene_tables(self.tree, self.device, low)

        def program(prev, i, img, new):
            h = _hist_dict(prev)
            h = {k: ({f: (v.to(low) if v.is_floating_point() else v) for f, v in h[k].items()}
                     if isinstance(h[k], dict) else h[k].to(low)) for k in h}
            loc, orient = self.locs[i % self.loop], self.ors[i % self.loop]
            return rf.temporal_frame(sc, loc.to(low), orient.to(low), h, self.frame_base + i, self.rc)

        rows = self.frames_compared(program)
        return {"control": {k: max(r[k] for r in rows) for k in rows[0]}}

    def facts(self) -> dict:
        px = int(self.rc["width"]) * int(self.rc["height"])
        return {"tree": self.tree, "rc": self.rc, "pixels": px, "shaded": getattr(self, "shaded", px),
                "per_step": {"k1": 1, "k2": 2}, "frame_times_ms": self.frame_times}

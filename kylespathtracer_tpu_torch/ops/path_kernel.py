"""The multi-bounce wavefront path integrator: one CUDA kernel (K7) and its
plain version.

Port of kylespathtracer_tpu/ops/path_kernel.py. Per pixel and sample: the
whole path — raygen, per bounce an inside-hit trace, the closed-form normal,
the material, MIS-weighted emission, next-event estimation toward the sphere
light with a balance heuristic, and a BSDF sample (diffuse, glossy, mirror,
dielectric) — with the PCG-rotated R2 sampler. `path_block` is the
component-plane math as plain tensor ops (the shade core's `_trace`,
`_light_visible`, `_surface` and the frame's `_normal_curv`);
`pathtrace_plain` runs it over the whole image (≙ `pathtrace_jnp`);
`pathtrace` launches csrc/path_kernel.cu on a CUDA tensor (≙
`pathtrace_pallas`) and runs `pathtrace_plain` on a CPU tensor. Given an
exposure (`brightness`), `pathtrace` returns the tonemapped sRGB image
instead of the HDR radiance: K7 tonemaps in its epilogue, in the same
operations as the plain chain that the CPU route runs after it.

The render/wavefront.py integrator is the JAX package's XLA oracle of the
same estimator; the two differ on purpose in a few guards (see there).
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.core import color, gmath, sampler
from kylespathtracer_tpu_torch.ops import _build
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import shade_kernel as sk
from kylespathtracer_tpu_torch.scene.types import BSDF, Scene, bsdf_table

# Launches of the CUDA kernel by `pathtrace` in this process, and those of
# them that wrote the tonemapped sRGB image (`brightness` given).
LAUNCHES = 0
TONEMAP_LAUNCHES = 0

_INV_PI = 1.0 / gmath.PI
_DELTA_PDF = 1e8

# One flipped sampling decision (a lobe, a TIR test, a Fresnel roulette)
# changes the whole path after it, so two computations of the same image
# are compared by statistics, as the JAX package compares its kernel with
# its XLA integrator (tests/test_pallas_small.py:340-341): finite, median
# |Δ| below MEDIAN_ABS, at most FAR_SHARE of the components beyond FAR.
MEDIAN_ABS = 1e-5
FAR = 3e-2
FAR_SHARE = 0.02


# ------------------------------------------------------------- pieces

def _light_sample(sc, hl, u1, u2):
    """Uniform solid-angle cone toward the light → (wi, pdf, outside)."""
    lx, ly, lz, lr = sk._light_vec(sc)
    lv = (lx - hl[0], ly - hl[1], lz - hl[2])
    d2 = torch.clamp(sk._dot(lv, lv), min=1e-12)
    r2 = lr * lr
    cos_max = torch.sqrt(torch.clamp(1.0 - sk._clip(r2 / d2, 0.0, 1.0), min=1e-9))
    ct = 1.0 - u1 * (1.0 - cos_max)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=1e-12))
    phi = gmath.TWOPI * u2
    w = sk._normalize(lv)
    f, r = sk._basis(w)
    cp, sp = torch.cos(phi), torch.sin(phi)
    wi = tuple(f[k] * (st * cp) + r[k] * (st * sp) + w[k] * ct for k in range(3))
    pdf = 1.0 / (gmath.TWOPI * torch.clamp(1.0 - cos_max, min=1e-9))
    return wi, pdf, d2 > r2


def _nee_pdf_from(sc, ro):
    """Solid-angle pdf the light sampler gives a light-reaching direction
    from `ro`."""
    lx, ly, lz, lr = sk._light_vec(sc)
    lv = (lx - ro[0], ly - ro[1], lz - ro[2])
    d2 = torch.clamp(sk._dot(lv, lv), min=1e-12)
    cos_max = torch.sqrt(torch.clamp(1.0 - sk._clip(lr * lr / d2, 0.0, 1.0), min=1e-9))
    return 1.0 / (gmath.TWOPI * torch.clamp(1.0 - cos_max, min=1e-9))


def _table(tab, oid, nK):
    """Per-id lookup as a where-chain; ids outside [0, nK) give 0."""
    out = torch.zeros_like(oid, dtype=tab.dtype)
    for k in range(nK):
        out = torch.where(oid == k, tab[k], out)
    return out


def _bsdf_eval_pdf(kind, rho_d, rho_s, n, wo, wi, gloss):
    """(f·cosθi per channel, pdf) of the non-delta lobes."""
    ci = torch.clamp(sk._dot(n, wi), min=0.0)
    f_d = tuple(rho_d[c] * (_INV_PI * ci) for c in range(3))
    pdf_d = ci * _INV_PI
    refl = sk._reflect((-wo[0], -wo[1], -wo[2]), n)
    ca = torch.clamp(sk._dot(refl, wi), min=0.0)
    ca_g = sk._powi(ca, int(gloss))
    fac_g = (gloss + 2.0) / gmath.TWOPI * ca_g * ci
    f_g = tuple(rho_s[c] * fac_g for c in range(3))
    pdf_g = (gloss + 1.0) / gmath.TWOPI * ca_g

    is_g = kind == BSDF.GLOSSY
    zero = (kind >= BSDF.MIRROR) | (ci <= 0.0)
    f = tuple(torch.where(zero, 0.0, torch.where(is_g, f_g[c], f_d[c])) for c in range(3))
    return f, torch.where(zero, 0.0, torch.where(is_g, pdf_g, pdf_d))


def _bsdf_sample(kind, rho_d, rho_s, eta, n, wo, gloss, u1, u2, u3):
    """Sample wi from the BSDF → (wi, weight3, pdf, is_delta, transmit)."""
    f, r = sk._basis(n)
    phi = gmath.TWOPI * u2
    cp, sp = torch.cos(phi), torch.sin(phi)

    # DIFFUSE: cosine hemisphere.
    srt = torch.sqrt(u1)
    x, y = srt * cp, srt * sp
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    wi_d = tuple(f[k] * x + r[k] * y + n[k] * z for k in range(3))
    pdf_d = z * _INV_PI

    # GLOSSY: power-cosine around the mirror direction.
    refl = sk._reflect((-wo[0], -wo[1], -wo[2]), n)
    fg, rg = sk._basis(refl)
    ca = u1 ** (1.0 / (gloss + 1.0))
    sa = torch.sqrt(torch.clamp(1.0 - ca * ca, min=0.0))
    wi_g = tuple(fg[k] * (sa * cp) + rg[k] * (sa * sp) + refl[k] * ca for k in range(3))
    wfac_g = torch.clamp((gloss + 2.0) / (gloss + 1.0) * sk._dot(n, wi_g), min=0.0)
    pdf_g = (gloss + 1.0) / gmath.TWOPI * sk._powi(ca, int(gloss))

    # DIELECTRIC: Schlick-Fresnel reflect/refract with TIR.
    ci = torch.clamp(sk._dot(n, wo), min=1e-6)
    sin2t = eta * eta * torch.clamp(1.0 - ci * ci, min=0.0)
    tir = sin2t > 1.0
    cost = torch.sqrt(torch.clamp(1.0 - sin2t, min=1e-9))
    r0 = (eta - 1.0) / (eta + 1.0)
    r0 = r0 * r0
    u = 1.0 - ci
    uu = u * u
    fres = r0 + (1.0 - r0) * uu * uu * u
    take_refl = u3 < torch.where(tir, 1.0, fres)
    fac = eta * ci - cost
    wi_t = sk._normalize(tuple(-wo[k] * eta + n[k] * fac for k in range(3)))
    wi_x = sk._where_v(take_refl, refl, wi_t)

    is_g = kind == BSDF.GLOSSY
    is_m = kind == BSDF.MIRROR
    is_x = kind == BSDF.DIELECTRIC
    is_delta = is_m | is_x
    wi = sk._where_v(is_x, wi_x, sk._where_v(is_m, refl, sk._where_v(is_g, wi_g, wi_d)))
    weight = tuple(
        torch.where(is_delta, rho_d[c] + rho_s[c], torch.where(is_g, rho_s[c] * wfac_g, rho_d[c]))
        for c in range(3)
    )
    pdf = torch.where(is_delta, _DELTA_PDF, torch.where(is_g, pdf_g, pdf_d))
    return wi, weight, pdf, is_delta, is_x & ~take_refl


# ------------------------------------------------------------- the block

def path_block(
    sc, kinds, iors, cam, orient, frame: int, row0: int,
    *, counts, nK, gloss, width, height, fov, block_rows, max_depth, spp, sample_id,
    tally=None,
):
    """One radiance sample (sample index `sample_id` of `spp`) for image
    rows [row0, row0+block_rows) as plain tensor ops → 3 HDR planes. A dict
    `tally` gets, summed over the bounces, the paths still alive at a
    bounce ("traced": each traces a segment) and those whose segment hit
    ("hits": each shades a vertex), the work K7 does on this data."""
    sc = dict(sc)
    sc["nK"] = nK
    device = sc["planes"].device
    shape = (block_rows, width)
    light_id = sc["light_id_arr"][0, 0]

    px, py, ro, rd = fk._raygen(shape, cam, orient, width, height, fov, row0, device)
    stream0 = sampler.pixel_stream(px, py, width, 0)
    n_idx = torch.full(shape, (int(frame) * int(spp) + int(sample_id)) & 0xFFFFFFFF,
                       dtype=torch.int64, device=device)

    def r2(pair):
        return sampler.r2_pair(n_idx, (stream0 + pair) & 0xFFFFFFFF)

    zero = torch.zeros(shape, dtype=torch.float32, device=device)
    one = torch.ones(shape, dtype=torch.float32, device=device)
    tp = (one, one, one)
    rad = (zero, zero, zero)
    alive = torch.ones(shape, dtype=torch.bool, device=device)
    excl = torch.full(shape, -1, dtype=torch.int32, device=device)
    prev_pdf = zero
    prev_delta = torch.ones(shape, dtype=torch.bool, device=device)
    prev_nee = torch.zeros(shape, dtype=torch.bool, device=device)
    inside = torch.zeros(shape, dtype=torch.bool, device=device)

    for bounce in range(max_depth):
        t, oid = sk._trace(sc, ro, rd, excl, *counts, inside_hits=True)
        hit = (oid != 0) & alive
        if tally is not None:
            tally["traced"] = tally.get("traced", 0) + int(alive.sum())
            tally["hits"] = tally.get("hits", 0) + int(hit.sum())
        hl = tuple(ro[k] + rd[k] * t for k in range(3))

        n_geo, _ = fk._normal_curv(sc, counts, hl, oid)
        # Misses keep a finite placeholder normal (masked out by `hit`).
        n_geo = sk._where_v(sk._dot(n_geo, n_geo) < 0.5, (zero, one, zero), n_geo)
        into = sk._dot(rd, n_geo) < 0.0
        n = sk._where_v(into, n_geo, tuple(-c for c in n_geo))
        wo = tuple(-c for c in rd)

        alb, emi, ene = sk._surface(sc, oid, hl, nK)
        kind = _table(kinds, oid, nK)
        ior = _table(iors, oid, nK)
        rho_d = tuple(alb[c] * ene[0] for c in range(3))
        rho_s = tuple(alb[c] * ene[1] for c in range(3))

        # Emitted radiance, MIS-weighted against the previous NEE.
        is_light = oid == light_id
        w_mis = torch.where(
            prev_delta | ~prev_nee | ~is_light, 1.0,
            prev_pdf / torch.clamp(prev_pdf + _nee_pdf_from(sc, ro), min=1e-12))
        emi_fac = torch.where(hit, w_mis, 0.0)
        rad = tuple(rad[c] + tp[c] * emi[c] * emi_fac for c in range(3))

        # Next-event estimation; shadow rays take the near root.
        u1, u2 = r2(bounce * 3 + 0)
        l_wi, l_pdf, l_ok = _light_sample(sc, hl, u1, u2)
        ro_off = tuple(hl[k] + n[k] * gmath.EPS for k in range(3))
        visible = sk._light_visible(sc, counts, ro_off, l_wi, oid)
        f_cos, b_pdf = _bsdf_eval_pdf(kind, rho_d, rho_s, n, wo, l_wi, gloss)
        w_nee = l_pdf / torch.clamp(l_pdf + b_pdf, min=1e-12)
        nee_on = hit & visible & l_ok & ~is_light
        nee_fac = torch.where(nee_on, w_nee / torch.clamp(l_pdf, min=1e-12), 0.0)
        rad = tuple(rad[c] + tp[c] * f_cos[c] * sc["light_color"][0, c] * nee_fac for c in range(3))

        # Continue the path with a BSDF sample.
        b1, b2 = r2(bounce * 3 + 1)
        b3, _ = r2(bounce * 3 + 2)
        eta_rel = torch.where(inside, ior, 1.0 / torch.clamp(ior, min=1e-6))
        wi, weight, pdf, is_delta, transmit = _bsdf_sample(
            kind, rho_d, rho_s, eta_rel, n, wo, gloss, b1, b2, b3)
        new_tp = tuple(tp[c] * weight[c] for c in range(3))
        tp_max = torch.maximum(new_tp[0], torch.maximum(new_tp[1], new_tp[2]))
        alive = hit & (tp_max > 1e-5)

        off = sk._where_v(transmit, tuple(-c for c in n), n)
        ro = tuple(hl[k] + off[k] * gmath.EPS for k in range(3))
        rd = wi
        tp = tuple(torch.where(alive, new_tp[c], 0.0) for c in range(3))
        excl = torch.where(transmit | inside, -1, oid)
        prev_pdf = pdf
        prev_delta = is_delta
        prev_nee = hit & l_ok & ~is_light
        inside = transmit ^ inside

    return rad


def _tables(scene: Scene):
    """The per-id BSDF kinds (i32[K]) and iors (f32[K]) as the kernel reads them."""
    kinds, iors = bsdf_table(scene.materials)
    k = scene.materials.num_ids
    if kinds.shape != (k,) or iors.shape != (k,):
        raise ValueError(f"materials.bsdf and .ior need {k} entries, one per id "
                         f"(got {tuple(kinds.shape)} and {tuple(iors.shape)})")
    return kinds.to(torch.int32).contiguous(), iors.to(torch.float32).contiguous()


def pathtrace_plain(scene: Scene, camera, config, frame=0, tally=None) -> torch.Tensor:
    """`path_block` over the whole image, the samples summed in order and
    divided by spp → HDR radiance f32[H, W, 3], on the scene's device.
    `tally`: see `path_block`."""
    H, W = config.height, config.width
    ops = fk.small_operands(scene, camera, frame)
    sc = dict(zip(fk.SC_KEYS, ops[:17]))
    kinds, iors = _tables(scene)
    spp = max(1, config.spp)
    acc = None
    for s in range(spp):
        rad = path_block(
            sc, kinds, iors, ops[17], ops[18], int(frame), 0,
            counts=fk._counts(scene), nK=scene.materials.num_ids, gloss=config.gloss,
            width=W, height=H, fov=config.fov, block_rows=H, max_depth=config.max_depth,
            spp=spp, sample_id=s, tally=tally,
        )
        img = torch.stack(rad, dim=-1)
        acc = img if acc is None else acc + img
    return acc / spp


def pathtrace(scene: Scene, camera, config, frame=0, brightness=None) -> torch.Tensor:
    """HDR radiance image f32[H, W, 3]: `config.spp` samples per pixel at
    depth `config.max_depth`, one launch. With a `brightness`, the image
    times it, ACES fitted and sRGB instead (in [0, 1]). The scene's device
    picks the route: CUDA launches the kernel (or raises), which tonemaps
    in its epilogue; CPU runs `pathtrace_plain`, then core/color.py.
    Forward only: an input that requires grad raises (`path_backend="xla"`
    differentiates)."""
    fk.forward_only("the path kernel (K7)", 'path_backend="xla"', scene, camera)
    device = scene.device
    if device.type == "cpu":
        img = pathtrace_plain(scene, camera, config, frame)
        return img if brightness is None else color.linear_srgb(color.aces_fitted(img * brightness))
    launch, out = path_launch(scene, camera, config, frame, brightness=brightness)
    launch()
    return out


def path_launch(scene: Scene, camera, config, frame=0, lib=None, brightness=None):
    """`pathtrace`'s CUDA route in two steps → (launch, out): the arguments
    are checked and the image allocated here; launch() launches K7 once
    into it and counts it. `brightness` None: out is the HDR radiance; a
    number: K7 multiplies the radiance by it and writes the ACES-fitted sRGB
    image (core/color.py's chain, operation for operation), and the launch
    also counts in TONEMAP_LAUNCHES. The kernel gathers the scene's tables
    from the scene's own tensors (`frame_kernel.table_parts`) and the BSDF
    kinds and iors from `_tables`; nothing is packed. ops/adjoint_variants.py
    times launch() alone beside `pathtrace`. `lib`: another build of the
    kernel (`census`), whose launches are not counted."""
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"pathtrace: unsupported device {device}")
    fk._check_scene(scene, camera, device)
    gloss = float(config.gloss)
    if gloss != int(gloss) or gloss < 1:
        raise ValueError(f"the path kernel needs an integral gloss >= 1 (got {gloss})")
    H, W = int(config.height), int(config.width)
    spp, depth = max(1, int(config.spp)), int(config.max_depth)
    parts = fk.table_parts(scene, camera)
    kinds, iors = _tables(scene)
    out = torch.empty((H, W, 3), dtype=torch.float32, device=device)
    tonemap = brightness is not None
    args = (*fk._counts(scene), scene.materials.num_ids, W, H, float(config.fov), fk._wrap32(int(frame)),
            spp, depth, int(gloss), int(tonemap), float(brightness) if tonemap else 0.0)
    stream = torch.cuda.current_stream(device).cuda_stream

    # launch() reads the tensors itself, so it keeps alive what the kernel
    # reads and writes after the caller has dropped them.
    def launch():
        global LAUNCHES, TONEMAP_LAUNCHES
        err = (lib or _build.load()).kpt_pathtrace(fk.table_parts_struct(*parts), kinds.data_ptr(),
                                                    iors.data_ptr(), *args, out.data_ptr(), stream)
        _build.check(err, "kpt_pathtrace")
        if lib is None:
            LAUNCHES += 1
            TONEMAP_LAUNCHES += tonemap

    return launch, out


# K7 built alone with PATH_CENSUS (csrc/path_kernel.cu): the census build.
CENSUS_BUILD = {"sources": ("path_kernel.cu",), "defines": ("PATH_CENSUS",)}
CENSUS_BITS = 5


def census(scene: Scene, camera, config, frame=0) -> torch.Tensor:
    """Where K7's lanes spend a launch: the census build run once on this
    image → int32[spp, H, W], per sample and pixel CENSUS_BITS bits for each
    bounce b at CENSUS_BITS·b: the segment is traced (bit 0); the box cull
    passes its ray, tmax the nearest plane or sphere hit (1); the light is
    tested from its vertex (2); that test finds no plane or sphere in the way
    and so, uncut, runs the boxes (3); the cull passes the test's segment
    (4). The census only reads: the image is K7's. Needs max_depth <= 6."""
    import ctypes

    if not 0 < int(config.max_depth) <= 32 // CENSUS_BITS:
        raise ValueError(f"the census holds up to {32 // CENSUS_BITS} bounces (max_depth {config.max_depth})")
    lib = ctypes.CDLL(str(_build.build(**CENSUS_BUILD)))
    lib.kpt_pathtrace.argtypes, lib.kpt_pathtrace.restype = list(_build._SIGNATURES["kpt_pathtrace"]), ctypes.c_int
    lib.kpt_path_census.argtypes, lib.kpt_path_census.restype = [ctypes.c_void_p], ctypes.c_int
    launch, _ = path_launch(scene, camera, config, frame, lib=lib)
    buf = torch.zeros((max(1, int(config.spp)), int(config.height), int(config.width)), dtype=torch.int32,
                      device=scene.device)
    _build.check(lib.kpt_path_census(buf.data_ptr()), "kpt_path_census")
    launch()
    torch.cuda.synchronize(scene.device)
    return buf


def census_report(c: torch.Tensor, depth: int) -> list:
    """`census` → lines: per bounce the live lanes, the warps with a live
    lane (a warp: two rows of 16 pixels of K7's 16×8 block, as the nested
    loop of the earlier design ran them) and the idle lanes in them; for
    the trace and for the light test the lanes that need the box and the
    warps that run its candidates uncut, culled lane by lane, and deferred to
    the block (⌈n/32⌉ warps for the block's n rays); then the warp
    iterations of the launch: the nested loop (a warp runs each sample to
    its longest path), the flat loop (a lane starts its next sample as its
    path ends), the flat loop run by the block in step, and the ideal."""
    spp, H, W = c.shape
    c = c.to(torch.int64)

    def warps(v):  # [spp, H, W] → [spp, H/8, W/16, 4 warps, 32 lanes]
        return v.reshape(spp, H // 8, 4, 2, W // 16, 16).permute(0, 1, 4, 2, 3, 5).reshape(spp, H // 8, W // 16, 4, 32)

    def deferred(need):
        return int(torch.ceil(warps(need).sum((-1, -2)) / 32).sum())

    lanes = spp * H * W
    lines = []
    for b in range(depth):
        alive, t_need, nee, reach, l_need = (((c >> (CENSUS_BITS * b + k)) & 1).bool() for k in range(5))
        n_alive = int(alive.sum())
        if n_alive == 0:
            lines.append(f"bounce {b}: no live lanes")
            continue
        live_warps = int(warps(alive).any(-1).sum())
        lines.append(
            f"bounce {b}: live lanes {n_alive / lanes:.4f} of W·H·spp; warps with a live lane {live_warps}, "
            f"idle lanes in them {1 - n_alive / (32 * live_warps):.4f}; trace: live lanes the cull passes "
            f"{int(t_need.sum()) / n_alive:.4f}, warps running the box uncut {live_warps} / culled "
            f"{int(warps(t_need).any(-1).sum())} / deferred {deferred(t_need)}; light test: lanes "
            f"{int(nee.sum()) / n_alive:.4f} of the live, reaching the boxes {int(reach.sum()) / n_alive:.4f}, the "
            f"cull passes {int(l_need.sum()) / n_alive:.4f}; warps running the box uncut "
            f"{int(warps(reach).any(-1).sum())} / culled {int(warps(l_need).any(-1).sum())} / deferred "
            f"{deferred(l_need)}")
    length = warps(sum(((c >> (CENSUS_BITS * b)) & 1) for b in range(depth)))  # segments per sample and lane
    nested = int(length.amax(-1).sum())
    flat = int(length.sum(0).amax(-1).sum())
    block = int(length.sum(0).amax((-1, -2)).sum()) * 4
    ideal = int(length.sum()) / 32
    lines.append(f"warp iterations: nested loop {nested}, flat loop {flat} ({flat / nested:.4f}), the block's "
                 f"flat loop {block} ({block / nested:.4f}), ideal {ideal:.1f} ({ideal / nested:.4f})")
    return lines


def disagreement(img: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far two radiance images part → {"finite": img all finite,
    "median", "max": |Δ|, "beyond_3e-2", "beyond_1e-3": shares of the
    components beyond those}."""
    d = (img - ref).abs()
    return {"finite": bool(torch.isfinite(img).all()), "median": d.median().item(),
            "beyond_3e-2": (d > FAR).float().mean().item(),
            "beyond_1e-3": (d > 1e-3).float().mean().item(), "max": d.max().item()}


def check_agreement(img, ref, what: str, median: float = MEDIAN_ABS) -> dict:
    """`disagreement` held to finite, median |Δ| < `median` and under
    FAR_SHARE of the components beyond FAR; raises AssertionError, else
    returns the stats."""
    stats = disagreement(img, ref)
    if not (stats["finite"] and stats["median"] < median and stats["beyond_3e-2"] < FAR_SHARE):
        raise AssertionError(f"{what}: the images part beyond the bar: {stats}")
    return stats

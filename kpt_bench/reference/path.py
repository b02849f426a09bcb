"""The plain reference of the multi-bounce path-traced image (BASELINE config 3).

Plain PyTorch, no kernels. It imports nothing of the program: per pixel and
sample, the whole path of the port's path kernel (K7, csrc/path_kernel.cu) —
raygen, per bounce an inside-hit trace, the closed-form normal, the material,
emission weighted by the balance heuristic against the previous vertex's
next-event estimate, one next-event estimate toward the sphere light, and a
BSDF sample (diffuse, glossy, mirror or dielectric) — with the PCG-rotated R2
sampler at sample index frame·spp + s; the samples summed in order and the sum
divided by spp; then exposure, ACES fitted and sRGB.

Frozen copies of the port's `ops/path_kernel.py` (`_light_sample`,
`_nee_pdf_from`, `_bsdf_eval_pdf`, `_bsdf_sample`, `_table`, `path_block`),
`core/sampler.py` (`pixel_stream`, `r2_pair`, `_mul32`) and the tonemap of
`render/wavefront.render_pathtraced`, on the copies already here: the shade
core's `_trace(inside_hits=True)`, `_light_visible`, `_surface`, `_powi`,
`_reflect` and, keeping its dtype, `_basis` (shade.py), the frame's
`_raygen`, `_normal_curv`, `_aces_srgb` and `scene_tables` (frame.py), the
PCG hash (gm.py).

The guards are K7's, not those of the port's `xla` integrator
(render/wavefront.py): the sphere roots take sqrt(max(disc, 1e-12)), the
relative index 1/max(ior, 1e-6), the gloss power `_powi`, the shadow ray the
occlusion test `_light_visible`. Departures from `path_kernel.py`: none. The
mean over the samples divides by a tensor, as K7 divides, where the plain
version divides by a Python number (the same for a power of two).

`dtype` is float32 for the reference and bfloat16 for the control of
`correct`; the sampler's draws are made in float32 (an integer hash and an
exact 24-bit conversion) and then rounded to `dtype`.
"""

from __future__ import annotations

import torch

from kpt_bench.reference import frame as rf
from kpt_bench.reference import gm
from kpt_bench.reference import shade as sk

# BSDF lobe kinds of the materials' `bsdf` table (scene/types.BSDF).
DIFFUSE, GLOSSY, MIRROR, DIELECTRIC = 0, 1, 2, 3
KINDS = {"DIFFUSE": DIFFUSE, "GLOSSY": GLOSSY, "MIRROR": MIRROR, "DIELECTRIC": DIELECTRIC}

_INV_PI = 1.0 / gm.PI
_DELTA_PDF = 1e8
_M32 = 0xFFFFFFFF
# R2 lattice constants round(2^32 / phi2^k), phi2 the plastic constant.
_R2_A1 = 3242174889
_R2_A2 = 2447445413


# ------------------------------------------------------------- the sampler

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x·c) mod 2^32 for x in [0, 2^32) held in int64 and a constant c in
    [0, 2^32), in two 16-bit halves of c so no product passes 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def r2_pair(n: torch.Tensor, stream: torch.Tensor) -> tuple:
    """The n-th point of the 2D R2 sequence, PCG-rotated per stream → two
    f32 uniforms in [0, 1)."""
    n = n.to(torch.int64) & _M32
    rot1 = gm._pcg_hash(stream)
    rot2 = gm._pcg_hash(rot1 ^ 0x9E3779B9)
    u1 = ((_mul32(n, _R2_A1) + rot1) & _M32) >> 8
    u2 = ((_mul32(n, _R2_A2) + rot2) & _M32) >> 8
    return u1.to(torch.float32) * 2.0**-24, u2.to(torch.float32) * 2.0**-24


def pixel_stream(px: torch.Tensor, py: torch.Tensor, width: int, pair) -> torch.Tensor:
    """Stream id of (pixel, dimension pair): (py·width + px)·0x85EBCA6B +
    pair in uint32, held in int64."""
    pid = (_mul32(py.to(torch.int64) & _M32, int(width) & _M32) + (px.to(torch.int64) & _M32)) & _M32
    return (_mul32(pid, 0x85EBCA6B) + (int(pair) & _M32)) & _M32


# ------------------------------------------------------------- the pieces

def _basis(n):
    """shade.py's branchless ONB with its sign in the dtype of `n`: there a
    select of two Python numbers is float32, which would lift the rest of a
    bfloat16 path to float32 (the same numbers in float32)."""
    nx, ny, nz = n
    s = torch.where(nz >= 0.0, 1.0, -1.0).to(nz.dtype)
    a = 1.0 / (s + nz)
    b = -nx * ny * a
    f = (1.0 - nx * nx * a * s, b * s, -nx * s)
    r = (b, s - ny * ny * a, -ny)
    return f, r


def _light_sample(sc, hl, u1, u2):
    """Uniform solid-angle cone toward the light → (wi, pdf, outside)."""
    lx, ly, lz, lr = sk._light_vec(sc)
    lv = (lx - hl[0], ly - hl[1], lz - hl[2])
    d2 = torch.clamp(sk._dot(lv, lv), min=1e-12)
    r2 = lr * lr
    cos_max = torch.sqrt(torch.clamp(1.0 - sk._clip(r2 / d2, 0.0, 1.0), min=1e-9))
    ct = 1.0 - u1 * (1.0 - cos_max)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=1e-12))
    phi = gm.TWOPI * u2
    w = sk._normalize(lv)
    f, r = _basis(w)
    cp, sp = torch.cos(phi), torch.sin(phi)
    wi = tuple(f[k] * (st * cp) + r[k] * (st * sp) + w[k] * ct for k in range(3))
    pdf = 1.0 / (gm.TWOPI * torch.clamp(1.0 - cos_max, min=1e-9))
    return wi, pdf, d2 > r2


def _nee_pdf_from(sc, ro):
    """Solid-angle pdf the light sampler gives a light-reaching direction
    from `ro`."""
    lx, ly, lz, lr = sk._light_vec(sc)
    lv = (lx - ro[0], ly - ro[1], lz - ro[2])
    d2 = torch.clamp(sk._dot(lv, lv), min=1e-12)
    cos_max = torch.sqrt(torch.clamp(1.0 - sk._clip(lr * lr / d2, 0.0, 1.0), min=1e-9))
    return 1.0 / (gm.TWOPI * torch.clamp(1.0 - cos_max, min=1e-9))


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
    fac_g = (gloss + 2.0) / gm.TWOPI * ca_g * ci
    f_g = tuple(rho_s[c] * fac_g for c in range(3))
    pdf_g = (gloss + 1.0) / gm.TWOPI * ca_g

    is_g = kind == GLOSSY
    zero = (kind >= MIRROR) | (ci <= 0.0)
    f = tuple(torch.where(zero, 0.0, torch.where(is_g, f_g[c], f_d[c])) for c in range(3))
    return f, torch.where(zero, 0.0, torch.where(is_g, pdf_g, pdf_d))


def _bsdf_sample(kind, rho_d, rho_s, eta, n, wo, gloss, u1, u2, u3):
    """Sample wi from the BSDF → (wi, weight3, pdf, is_delta, transmit)."""
    f, r = _basis(n)
    phi = gm.TWOPI * u2
    cp, sp = torch.cos(phi), torch.sin(phi)

    # DIFFUSE: cosine hemisphere.
    srt = torch.sqrt(u1)
    x, y = srt * cp, srt * sp
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    wi_d = tuple(f[k] * x + r[k] * y + n[k] * z for k in range(3))
    pdf_d = z * _INV_PI

    # GLOSSY: power-cosine around the mirror direction.
    refl = sk._reflect((-wo[0], -wo[1], -wo[2]), n)
    fg, rg = _basis(refl)
    ca = u1 ** (1.0 / (gloss + 1.0))
    sa = torch.sqrt(torch.clamp(1.0 - ca * ca, min=0.0))
    wi_g = tuple(fg[k] * (sa * cp) + rg[k] * (sa * sp) + refl[k] * ca for k in range(3))
    wfac_g = torch.clamp((gloss + 2.0) / (gloss + 1.0) * sk._dot(n, wi_g), min=0.0)
    pdf_g = (gloss + 1.0) / gm.TWOPI * sk._powi(ca, int(gloss))

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

    is_g = kind == GLOSSY
    is_m = kind == MIRROR
    is_x = kind == DIELECTRIC
    is_delta = is_m | is_x
    wi = sk._where_v(is_x, wi_x, sk._where_v(is_m, refl, sk._where_v(is_g, wi_g, wi_d)))
    weight = tuple(
        torch.where(is_delta, rho_d[c] + rho_s[c], torch.where(is_g, rho_s[c] * wfac_g, rho_d[c]))
        for c in range(3)
    )
    pdf = torch.where(is_delta, _DELTA_PDF, torch.where(is_g, pdf_g, pdf_d))
    return wi, weight, pdf, is_delta, is_x & ~take_refl


# ------------------------------------------------------------- the paths

def path_block(sc, kinds, iors, cam, orient, frame: int, row0: int, rows: int, rc: dict, sample_id: int,
               tally=None):
    """One radiance sample (sample `sample_id` of rc["spp"]) for image rows
    [row0, row0+rows) → 3 HDR planes. A dict `tally` gets, summed over the
    bounces, the paths still alive at a bounce ("traced": each traces a
    segment) and those whose segment hit ("hits": each shades a vertex)."""
    width, height, spp, gloss = int(rc["width"]), int(rc["height"]), int(rc["spp"]), float(rc["gloss"])
    counts, nK = sc["counts"], sc["nK"]
    dt = sc["planes"].dtype
    device = sc["planes"].device
    shape = (rows, width)
    light_id = sc["light_id_arr"][0, 0]

    px, py, ro, rd = rf._raygen(shape, cam, orient, width, height, float(rc["fov"]), row0, device)
    stream0 = pixel_stream(px, py, width, 0)
    n_idx = torch.full(shape, (int(frame) * spp + int(sample_id)) & _M32, dtype=torch.int64, device=device)

    def r2(pair):
        return tuple(u.to(dt) for u in r2_pair(n_idx, (stream0 + pair) & _M32))

    zero = torch.zeros(shape, dtype=dt, device=device)
    one = torch.ones(shape, dtype=dt, device=device)
    tp = (one, one, one)
    rad = (zero, zero, zero)
    alive = torch.ones(shape, dtype=torch.bool, device=device)
    excl = torch.full(shape, -1, dtype=torch.int32, device=device)
    prev_pdf = zero
    prev_delta = torch.ones(shape, dtype=torch.bool, device=device)
    prev_nee = torch.zeros(shape, dtype=torch.bool, device=device)
    inside = torch.zeros(shape, dtype=torch.bool, device=device)

    for bounce in range(int(rc["max_depth"])):
        t, oid = sk._trace(sc, ro, rd, excl, *counts, inside_hits=True)
        hit = (oid != 0) & alive
        if tally is not None:
            tally["traced"] = tally.get("traced", 0) + int(alive.sum())
            tally["hits"] = tally.get("hits", 0) + int(hit.sum())
        hl = tuple(ro[k] + rd[k] * t for k in range(3))

        n_geo, _ = rf._normal_curv(sc, counts, hl, oid)
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
        ro_off = tuple(hl[k] + n[k] * gm.EPS for k in range(3))
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
        wi, weight, pdf, is_delta, transmit = _bsdf_sample(kind, rho_d, rho_s, eta_rel, n, wo, gloss, b1, b2, b3)
        new_tp = tuple(tp[c] * weight[c] for c in range(3))
        tp_max = torch.maximum(new_tp[0], torch.maximum(new_tp[1], new_tp[2]))
        alive = hit & (tp_max > 1e-5)

        off = sk._where_v(transmit, tuple(-c for c in n), n)
        ro = tuple(hl[k] + off[k] * gm.EPS for k in range(3))
        rd = wi
        tp = tuple(torch.where(alive, new_tp[c], 0.0) for c in range(3))
        excl = torch.where(transmit | inside, -1, oid)
        prev_pdf = pdf
        prev_delta = is_delta
        prev_nee = hit & l_ok & ~is_light
        inside = transmit ^ inside

    return rad


def material_tables(tree: dict, device, dtype=torch.float32) -> tuple:
    """The per-id BSDF kinds (i32[K]) and iors (`dtype`[K]) of a scene given
    as numpy tables."""
    m = tree["materials"]
    return (torch.as_tensor(m["bsdf"], device=device).to(torch.int32),
            torch.as_tensor(m["ior"], device=device).to(dtype))


@torch.no_grad()
def hdr_image(sc, kinds, iors, cam, orient, frame: int, rc: dict, block_rows: int = 270, tally=None):
    """HDR radiance f32/`dtype`[H, W, 3]: rc["spp"] samples a pixel at depth
    rc["max_depth"], summed in order and divided by spp, rendered in blocks
    of `block_rows` rows. `tally`: see `path_block`, over every block and
    sample."""
    H, spp = int(rc["height"]), max(1, int(rc["spp"]))
    parts = []
    for r0 in range(0, H, block_rows):
        rows = min(block_rows, H - r0)
        acc = None
        for s in range(spp):
            img = torch.stack(path_block(sc, kinds, iors, cam, orient, frame, r0, rows, dict(rc, spp=spp), s,
                                         tally), dim=-1)
            acc = img if acc is None else acc + img
        parts.append(acc / torch.tensor(float(spp), dtype=acc.dtype, device=acc.device))
    return torch.cat(parts, dim=0)


def render(sc, kinds, iors, cam, orient, frame: int, rc: dict, block_rows: int = 270, tally=None):
    """The tonemapped sRGB image [H, W, 3] in [0, 1]: `hdr_image` times the
    exposure rc["brightness"] → ACES fitted → sRGB."""
    return rf._aces_srgb(hdr_image(sc, kinds, iors, cam, orient, frame, rc, block_rows, tally)
                         * float(rc["brightness"]))

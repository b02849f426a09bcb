"""The shared shade core, plain PyTorch, in component-plane form.

Port of the per-pixel math of kylespathtracer_tpu/ops/shade_kernel.py: the
analytic nearest-hit trace, the occlusion-only visibility tests, the
material table, and the dual-MIS estimator pair (direct light + 2×2
plane-strategy roulettes, common.glsl:430-616) or the unbiased pair
(common.glsl:394-415). A "vec" is a tuple (x, y, z) of same-shape tensors;
`sc` is a dict of the small scene tables in the shapes of
`frame_kernel.small_operands`, so `sc["planes"][p, 0]` is a 0-d f32 tensor
and every scalar expression stays f32, as in the JAX code.

This is the plain version the frame kernel (csrc/frame_kernel.cu, whose
`__device__` mirror of this file is csrc/shade_core.cuh) is checked
against. `dual_mis` is the pass pipeline's shade kernel (K4, the
counterpart of `dual_mis_pallas`): the shade core on a G-buffer, one
sample per pixel; on a CUDA tensor it launches csrc/shade_kernel.cu, on a
CPU tensor it runs `dual_mis_plain`.
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.core import gmath

_INF = 1e9

# Launches of the CUDA kernel by `dual_mis` in this process.
LAUNCHES = 0


# ----------------------------------------------------------- vec3 helpers

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _normalize(a, eps=1e-20):
    inv = torch.rsqrt(torch.clamp(_dot(a, a), min=eps))
    return _scale(a, inv)


def _reflect(i, n):
    d = 2.0 * _dot(n, i)
    return (i[0] - d * n[0], i[1] - d * n[1], i[2] - d * n[2])


def _where_v(m, a, b):
    return tuple(torch.where(m, a[k], b[k]) for k in range(3))


def _clip(x, lo, hi):
    """jnp.clip: max then min, with tensor or float bounds."""
    lo = lo if isinstance(lo, torch.Tensor) else torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi = hi if isinstance(hi, torch.Tensor) else torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _weyl3(seed):
    """Bit-faithful int32 Weyl draws (common.glsl:43-45) in component form."""
    out = []
    for k in (13743434, 11258243, 9222443):
        prod = (seed * k).to(torch.float32) / 16777216.0
        out.append(prod - torch.floor(prod))
    return out


def _basis(n):
    """Branchless ONB (common.glsl:53-59)."""
    nx, ny, nz = n
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = 1.0 / (s + nz)
    b = -nx * ny * a
    f = (1.0 - nx * nx * a * s, b * s, -nx * s)
    r = (b, s - ny * ny * a, -ny)
    return f, r


def _cone_pre(seed):
    """Per-pixel cone-sampling draws, hoisted: sqrt(u1), cos/sin(2π·u2), u3."""
    u1, u2, u3 = _weyl3(seed)
    tha = u2 * gmath.TWOPI
    return torch.sqrt(u1), torch.cos(tha), torch.sin(tha), u3


def _cone_dir(lv, lr, pre):
    """Cone sample toward a sphere (common.glsl:188-196); degenerate-safe."""
    su1, ct, st, _ = pre
    d = torch.sqrt(torch.clamp(_dot(lv, lv), min=1e-20))
    x = _clip(lr / torch.clamp(d, min=1e-12), gmath.EPS, gmath.IEPS)
    rad = su1 * x * torch.rsqrt(1.0 - x * x)
    nlv = _normalize(lv)
    f, r = _basis(nlv)
    o = tuple(nlv[k] + rad * (f[k] * ct + r[k] * st) for k in range(3))
    return _normalize(o)


def _solid_angle(d2, r2):
    inner = 1.0 - _clip(r2 / torch.clamp(d2, min=1e-24), 0.0, 1.0)
    return (1.0 - torch.sqrt(torch.clamp(inner, min=1e-12))) * gmath.TWOPI


def _schlick(r1, r2, vn):
    r0 = (r1 - r2) / (r1 + r2)
    r0 = r0 * r0
    u = 1.0 - vn
    u2 = u * u
    return r0 + (1.0 - r0) * u2 * u2 * u


def _powi(x, n: int):
    """x**n by repeated squaring, in the JAX code's multiplication order."""
    acc = None
    base = x
    n = int(n)
    while n:
        if n & 1:
            acc = base if acc is None else acc * base
        n >>= 1
        if n:
            base = base * base
    return acc


# ----------------------------------------------------------- intersection

def _trace(sc, ro, rd, excl, nP, nS, nB, inside_hits=False):
    """Nearest hit → (t, oid) over planes, spheres and rounded boxes
    (26 candidates each: 6 faces, 12 edge cylinders, 8 corner spheres).
    `inside_hits`: a ray that starts inside a sphere hits its far surface
    instead of missing (the path kernel's dielectric continuation rays)."""
    best_t = torch.full_like(ro[0], _INF)
    best_id = torch.zeros_like(excl)

    def consider(t, oid_scalar, valid):
        nonlocal best_t, best_id
        valid = valid & (t > 0) & (oid_scalar != excl) & (t < best_t)
        best_t = torch.where(valid, t, best_t)
        best_id = torch.where(valid, oid_scalar, best_id)

    for p in range(nP):
        t, valid = _plane_t(sc, p, ro, rd)
        consider(t, sc["plane_ids"][p, 0], valid)

    for s in range(nS):
        t, disc = _sphere_t(sc, s, ro, rd, inside_hits)
        consider(t, sc["sphere_ids"][s, 0], disc > 0)

    for bx in range(nB):
        c = (sc["boxes"][bx, 0], sc["boxes"][bx, 1], sc["boxes"][bx, 2])
        half = (sc["boxes"][bx, 3], sc["boxes"][bx, 4], sc["boxes"][bx, 5])
        rnd = sc["boxes"][bx, 6]
        oid = sc["box_ids"][bx, 0]
        o = _sub(ro, c)
        d = rd
        for k in range(3):  # 6 faces
            j1, j2 = (k + 1) % 3, (k + 2) % 3
            dk = torch.where(d[k].abs() < 1e-12, 1e-12, d[k])
            for sgn in (1.0, -1.0):
                t = (sgn * (half[k] + rnd) - o[k]) / dk
                p1 = o[j1] + d[j1] * t
                p2 = o[j2] + d[j2] * t
                consider(t, oid, (p1.abs() <= half[j1]) & (p2.abs() <= half[j2]))
        for k in range(3):  # 12 edge cylinders
            i, j = (k + 1) % 3, (k + 2) % 3
            a = torch.clamp(d[i] * d[i] + d[j] * d[j], min=1e-12)
            for si in (1.0, -1.0):
                for sj in (1.0, -1.0):
                    oi = o[i] - si * half[i]
                    oj = o[j] - sj * half[j]
                    b = oi * d[i] + oj * d[j]
                    cq = oi * oi + oj * oj - rnd * rnd
                    disc = b * b - a * cq
                    t = (-b - torch.sqrt(torch.clamp(disc, min=1e-12))) / a
                    pk = o[k] + d[k] * t
                    consider(
                        t, oid,
                        (disc > 0) & (pk.abs() <= half[k])
                        & ((oi + d[i] * t) * si > 0) & ((oj + d[j] * t) * sj > 0),
                    )
        for sx in (1.0, -1.0):  # 8 corner spheres
            for sy in (1.0, -1.0):
                for sz in (1.0, -1.0):
                    oc = (o[0] - sx * half[0], o[1] - sy * half[1],
                          o[2] - sz * half[2])
                    b = _dot(oc, d)
                    cq = _dot(oc, oc) - rnd * rnd
                    disc = b * b - cq
                    t = -b - torch.sqrt(torch.clamp(disc, min=1e-12))
                    consider(
                        t, oid,
                        (disc > 0) & ((oc[0] + d[0] * t) * sx > 0)
                        & ((oc[1] + d[1] * t) * sy > 0)
                        & ((oc[2] + d[2] * t) * sz > 0),
                    )

    # Pull back by eps; clamp misses (common.glsl:289-294).
    t = best_t - gmath.EPS
    miss = (t > gmath.ZFAR) | (best_id == 0)
    return torch.where(miss, gmath.ZFAR, t), torch.where(miss, 0, best_id)


def _plane_t(sc, p, o, d):
    """Raw candidate t of plane p and its front-facing test."""
    n0, n1, n2, w = (sc["planes"][p, k] for k in range(4))
    denom = d[0] * n0 + d[1] * n1 + d[2] * n2
    sd0 = o[0] * n0 + o[1] * n1 + o[2] * n2 + w
    t = -sd0 / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    return t, denom < -1e-7


def _sphere_t(sc, s, o, d, far=False):
    """Raw near-root t of sphere s and its discriminant; with `far`, the far
    root where the near one is not ahead of the ray."""
    oc = tuple(o[k] - sc["spheres"][s, k] for k in range(3))
    r = sc["spheres"][s, 3]
    b = _dot(oc, d)
    c2 = _dot(oc, oc) - r * r
    disc = b * b - c2
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    t = -b - sq
    if far:
        t = torch.where(t > 0, t, -b + sq)
    return t, disc


# ------------------------------------------------- occlusion-only tests

def _box_occludes(sc, bx, o, d, tmax):
    """Does rounded box bx intersect the open segment (0, tmax)? The squared
    distance to the inner box along the ray is convex piecewise-quadratic;
    its minimizer is bracketed by the slab-crossing candidates and found by
    one linear interpolation of the derivative."""
    c = (sc["boxes"][bx, 0], sc["boxes"][bx, 1], sc["boxes"][bx, 2])
    half = (sc["boxes"][bx, 3], sc["boxes"][bx, 4], sc["boxes"][bx, 5])
    rnd = sc["boxes"][bx, 6]
    op = _sub(o, c)

    inv_d = tuple(
        1.0 / torch.where(d[k].abs() < 1e-12, 1e-12, d[k]) for k in range(3)
    )
    zeros = torch.zeros_like(tmax)
    cands = [zeros, tmax]
    for k in range(3):
        for sgn in (1.0, -1.0):
            cands.append(_clip((sgn * half[k] - op[k]) * inv_d[k], 0.0, tmax))

    def gprime(t):
        acc = zeros
        for k in range(3):
            x = op[k] + d[k] * t
            acc = acc + d[k] * (x - _clip(x, -half[k], half[k]))
        return acc

    t_lo, t_hi = zeros, tmax
    gp_lo, gp_hi = gprime(zeros), gprime(tmax)
    for t_c in cands:
        gp = gprime(t_c)
        better_lo = (gp <= 0.0) & (t_c >= t_lo)
        t_lo = torch.where(better_lo, t_c, t_lo)
        gp_lo = torch.where(better_lo, gp, gp_lo)
        better_hi = (gp >= 0.0) & (t_c <= t_hi)
        t_hi = torch.where(better_hi, t_c, t_hi)
        gp_hi = torch.where(better_hi, gp, gp_hi)

    den = gp_hi - gp_lo
    small = den.abs() < 1e-20
    frac = torch.where(small, 0.0, gp_lo / torch.where(small, 1.0, den))
    t_star = _clip(t_lo - frac * (t_hi - t_lo), 0.0, tmax)

    g = zeros
    for k in range(3):
        x = op[k] + d[k] * t_star
        e = x - _clip(x, -half[k], half[k])
        g = g + e * e
    return g <= rnd * rnd


def _nearest_is_target(sc, counts, o, d, excl, t_target, target_valid,
                       skip_sphere_id=None):
    """True where the analytic target hit is the nearest scene hit from o
    along d: nothing else (except `excl` and `skip_sphere_id`) hits
    strictly before t_target."""
    nP, nS, nB = counts
    occ = torch.zeros_like(target_valid)
    for p in range(nP):
        t, front = _plane_t(sc, p, o, d)
        occ = occ | (front & (t > 0) & (sc["plane_ids"][p, 0] != excl)
                     & (t < t_target))
    for s in range(nS):
        sid = sc["sphere_ids"][s, 0]
        t, disc = _sphere_t(sc, s, o, d)
        v = (disc > 0) & (t > 0) & (sid != excl) & (t < t_target)
        if skip_sphere_id is not None:
            v = v & (sid != skip_sphere_id)
        occ = occ | v
    for bx in range(nB):
        occ = occ | ((sc["box_ids"][bx, 0] != excl)
                     & _box_occludes(sc, bx, o, d, t_target))
    return target_valid & ~occ & (t_target - gmath.EPS <= gmath.ZFAR)


def _light_vec(sc):
    return tuple(sc["light"][0, k] for k in range(4))


def _light_visible(sc, counts, o, d, excl):
    """Occlusion-style `nearest hit == light` (common.glsl:348-353)."""
    lx, ly, lz, lr = _light_vec(sc)
    oc = (o[0] - lx, o[1] - ly, o[2] - lz)
    b = _dot(oc, d)
    c2 = _dot(oc, oc) - lr * lr
    disc = b * b - c2
    t_l = -b - torch.sqrt(torch.clamp(disc, min=1e-12))
    light_id = sc["light_id_arr"][0, 0]
    valid = (disc > 0) & (t_l > 0) & (light_id != excl)
    return _nearest_is_target(sc, counts, o, d, excl, t_l, valid,
                              skip_sphere_id=light_id)


# ----------------------------------------------------------- materials

def _surface(sc, ho, hl, nK):
    """Per-ID material rows selected with a where-chain → (alb, emi, ene)."""
    alb = [torch.zeros_like(hl[0]) for _ in range(3)]
    emi = [torch.zeros_like(hl[0]) for _ in range(3)]
    ene = [torch.zeros_like(hl[0]) for _ in range(2)]
    for k in range(nK):
        sel = ho == k
        freq = sc["mat_freq"][k, 0]
        s = (torch.floor(hl[0] * freq) + torch.floor(hl[1] * freq)
             + torch.floor(hl[2] * freq))
        checker = torch.remainder(s, 2.0).abs()
        sval = sc["mat_s0"][k, 0] + sc["mat_s1"][k, 0] * checker
        for c in range(3):
            alb[c] = torch.where(
                sel, sc["mat_alb_const"][k, c] + sc["mat_alb_scale"][k, c] * sval,
                alb[c])
            emi[c] = torch.where(sel, sc["mat_emission"][k, c], emi[c])
        for c in range(2):
            ene[c] = torch.where(
                sel, sc["mat_en_const"][k, c] + sc["mat_en_scale"][k, c] * sval,
                ene[c])
    return tuple(alb), tuple(emi), tuple(ene)


# ----------------------------------------------------------- MIS pieces

def _plane_pdf_lambert(sc, p, hl, pre):
    """lambert_plane_pdf for plane p (common.glsl:308-322)."""
    lx, ly, lz, lr = _light_vec(sc)
    n = (sc["planes"][p, 0], sc["planes"][p, 1], sc["planes"][p, 2])
    w = sc["planes"][p, 3]
    ldn = lx * n[0] + ly * n[1] + lz * n[2] + w
    d = (lx - n[0] * ldn, ly - n[1] * ldn, lz - n[2] * ldn)
    dv = (d[0] - hl[0], d[1] - hl[1], d[2] - hl[2])
    ld = (lx - d[0], ly - d[1], lz - d[2])
    dv2 = _dot(dv, dv)
    frad = torch.minimum(
        torch.sqrt(torch.clamp(dv2, min=1e-20)),
        torch.sqrt(torch.clamp(_dot(ld, ld), min=1e-20)),
    ) * 0.9
    dir_ = _cone_dir(dv, frad, pre)
    lpdf = _solid_angle(dv2, frad * frad) / gmath.PI
    g2 = torch.clamp(-(dir_[0] * n[0] + dir_[1] * n[1] + dir_[2] * n[2]),
                     min=gmath.EPS)
    return dir_, torch.where(dv2 > 1e-12, lpdf * g2, 0.0)


def _plane_pdf_phong(sc, p, hl, pre):
    """phong_plane_pdf for plane p (common.glsl:325-343)."""
    lx, ly, lz, lr = _light_vec(sc)
    n = (sc["planes"][p, 0], sc["planes"][p, 1], sc["planes"][p, 2])
    w = sc["planes"][p, 3]
    a = _dot(hl, n) + w
    b = lx * n[0] + ly * n[1] + lz * n[2] + w
    ab = a + b
    ab = torch.where(ab.abs() < 1e-6, 1e-6, ab)
    fac = a / ab
    L = (lx, ly, lz)
    s = tuple(
        (hl[k] - a * n[k]) + ((L[k] - b * n[k]) - (hl[k] - a * n[k])) * fac
        for k in range(3)
    )
    sv = _sub(s, hl)
    sv2 = _dot(sv, sv)
    lsv = torch.sqrt(torch.clamp(sv2, min=1e-20)) * lr
    ls = (lx - s[0], ly - s[1], lz - s[2])
    lsn = torch.sqrt(torch.clamp(_dot(ls, ls), min=1e-20))
    ts = _scale(sv, lsn)
    dir_ = _cone_dir(ts, lsv, pre)
    lpdf = _solid_angle(_dot(ts, ts), lsv * lsv) / gmath.PI
    spdf = _schlick(1.0, 3.0, _dot(_normalize(sv), n))
    return dir_, torch.where(sv2 > 1e-12, lpdf * spdf, 0.0)


def _roulette(sc, counts, dirs, ws, hl, ho, pre, energy_channel, nP):
    """CDF roulette over the P plane strategies + contribution march
    (common.glsl:453-519), occlusion-style."""
    cdf = []
    acc = torch.zeros_like(ws[0])
    for p in range(nP):
        acc = acc + ws[p]
        cdf.append(acc)
    total = acc
    rnd = pre[3] * total

    # Select the first p with rnd <= cdf_p (last plane unconditional).
    idx = torch.zeros_like(ho)
    for p in range(nP - 1):
        idx = idx + (rnd > cdf[p]).to(idx.dtype)

    zero = torch.zeros_like(hl[0])
    dir_sel, w_sel = dirs[0], ws[0]
    n_sel = (zero, zero, zero)
    pw_sel = zero
    po_sel = torch.zeros_like(ho)
    for p in range(nP):
        m = idx == p
        dir_sel = _where_v(m, dirs[p], dir_sel)
        w_sel = torch.where(m, ws[p], w_sel)
        n_sel = _where_v(m, tuple(sc["planes"][p, k].expand_as(zero)
                                  for k in range(3)), n_sel)
        pw_sel = torch.where(m, sc["planes"][p, 3], pw_sel)
        po_sel = torch.where(m, sc["plane_ids"][p, 0], po_sel)

    # Analytic hit on the selected plane + occlusion verify (common.glsl:356-371).
    denom = _dot(dir_sel, n_sel)
    sd0 = _dot(hl, n_sel) + pw_sel
    tp = -sd0 / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    valid_p = (denom < -1e-7) & (tp > 0) & (po_sel != ho)
    ok = _nearest_is_target(sc, counts, hl, dir_sel, ho, tp, valid_p)

    t = tp - gmath.EPS
    hl2 = tuple(hl[k] + dir_sel[k] * t + n_sel[k] * gmath.EPS for k in range(3))
    lx, ly, lz, lr = _light_vec(sc)
    lv2 = (lx - hl2[0], ly - hl2[1], lz - hl2[2])
    sample_dir = _cone_dir(lv2, lr, pre)
    lhit = _light_visible(sc, counts, hl2, sample_dir, po_sel)
    lc = [torch.where(lhit, sc["light_color"][0, c] * w_sel, 0.0) for c in range(3)]
    alb, emi, ene = _surface(sc, po_sel, hl2, sc["nK"])
    e = ene[energy_channel]
    contrib = [emi[c] + e * alb[c] * lc[c] for c in range(3)]
    boost = total / torch.clamp(w_sel, min=gmath.EPS)
    return [torch.where(ok, contrib[c] * boost, 0.0) for c in range(3)]


# ------------------------------------------ unbiased ground truth

def _logit3(v):
    """common.glsl:48-51, component form: logit-warp ≈ gaussian."""
    out = []
    for c in v:
        t = 0.988 * (c + 0.006)
        out.append(torch.log(t / (1.0 - t)) * 0.221 + 0.5)
    return out


def _cos_hemi_dir(hn, seed):
    """cosHemiDir (common.glsl:182-185): normalize(n + uniformDir·ieps)."""
    g = _logit3(_weyl3(seed))
    d = _normalize(tuple(g[k] * 2.0 - 1.0 for k in range(3)))
    return _normalize(tuple(hn[k] + d[k] * gmath.IEPS for k in range(3)))


def _shade_core_unbiased(sc, counts, gloss, hn, rd, ho, hl, seed, smp,
                         decorrelate):
    """UnbiasedLambertian / UnbiasedPhong (common.glsl:394-415). The phong
    direction is seed-independent, so it is evaluated once."""
    from kylespathtracer_tpu_torch.ops.frame_kernel import _fold_seed

    est_d = [torch.zeros_like(hl[0]) for _ in range(3)]
    for i in range(smp):
        d = _cos_hemi_dir(hn, _fold_seed(seed, i, decorrelate))
        vis = _light_visible(sc, counts, hl, d, ho)
        for c in range(3):
            est_d[c] = est_d[c] + torch.where(
                vis, sc["light_color"][0, c] * gmath.PI, 0.0)
    if smp > 1:
        est_d = [e * (1.0 / float(smp)) for e in est_d]

    # Plain reflect, not re-normalized (mis.unbiased_phong parity).
    vis_s = _light_visible(sc, counts, hl, _reflect(rd, hn), ho)
    est_s = [torch.where(vis_s, sc["light_color"][0, c], 0.0) for c in range(3)]
    return est_d, est_s


# ----------------------------------------------------------- shade core

def _soft_transmittance(sc, nS, hl, dl_dir, t_surf, ho, beta: float):
    """Smooth shadow-ray visibility Π_spheres σ(sd_i/(β·t_i)), skipping the
    light and the shaded object itself."""
    trans = torch.ones_like(hl[0])
    light_id = sc["light_id_arr"][0, 0]
    for s in range(nS):
        c = (sc["spheres"][s, 0], sc["spheres"][s, 1], sc["spheres"][s, 2])
        r = sc["spheres"][s, 3]
        tc = _clip(_dot(_sub(c, hl), dl_dir), gmath.EPS, t_surf)
        closest = tuple(hl[k] + dl_dir[k] * tc - c[k] for k in range(3))
        sd = torch.sqrt(torch.clamp(_dot(closest, closest), min=1e-20)) - r
        v = torch.sigmoid(sd / (beta * tc))
        skip = (sc["sphere_ids"][s, 0] == light_id) | (sc["sphere_ids"][s, 0] == ho)
        trans = trans * torch.where(skip, 1.0, v)
    return trans


def _shade_core(sc, counts, nK, gloss, hn, rd, ho, hl, seed, soft_beta=0.0):
    """Direct light + the four plane-strategy roulettes for both estimators
    (common.glsl:430-616) → (est_d, est_s), unmasked. `soft_beta > 0`
    smooths the direct light's sphere occlusion."""
    lx, ly, lz, lr = _light_vec(sc)
    pre = _cone_pre(seed)
    lv = (lx - hl[0], ly - hl[1], lz - hl[2])
    dl_dir = _cone_dir(lv, lr, pre)
    dl_pdf = _solid_angle(_dot(lv, lv), lr * lr)
    lam_w = torch.clamp(_dot(dl_dir, hn), min=gmath.EPS)
    refl = _reflect(rd, hn)
    pho_w = _powi(torch.clamp(_dot(dl_dir, refl), min=gmath.EPS), int(gloss))

    if soft_beta > 0.0:
        _, vis_id = _trace(sc, hl, dl_dir, ho, *counts)
        nS = counts[1]
        dist = torch.sqrt(torch.clamp(_dot(lv, lv), min=1e-20))
        t_surf = torch.clamp(dist - lr, min=gmath.EPS)
        trans = _soft_transmittance(sc, nS, hl, dl_dir, t_surf, ho, soft_beta)
        sol = torch.zeros_like(ho, dtype=torch.bool)
        for s in range(nS):
            sol = sol | (vis_id == sc["sphere_ids"][s, 0])
        vis = torch.where(sol, trans, 0.0)
    else:
        vis = _light_visible(sc, counts, hl, dl_dir, ho).to(hl[0].dtype)

    est_d = [sc["light_color"][0, c] * (vis * dl_pdf * lam_w) for c in range(3)]
    est_s = [sc["light_color"][0, c] * (vis * dl_pdf * pho_w) for c in range(3)]

    nP = counts[0]
    dirs_l, wpdf_l, dirs_p, wpdf_p = [], [], [], []
    for p in range(nP):
        dl, pl_ = _plane_pdf_lambert(sc, p, hl, pre)
        dp_, pp_ = _plane_pdf_phong(sc, p, hl, pre)
        dirs_l.append(dl)
        wpdf_l.append(pl_)
        dirs_p.append(dp_)
        wpdf_p.append(pp_)

    def lam(d):
        return torch.clamp(_dot(d, hn), min=gmath.EPS)

    def pho(d):
        return _powi(torch.clamp(_dot(d, refl), min=gmath.EPS), int(gloss))

    wl_lam = [wpdf_l[p] * lam(dirs_l[p]) for p in range(nP)]
    wp_lam = [wpdf_p[p] * lam(dirs_p[p]) for p in range(nP)]
    wl_pho = [wpdf_l[p] * pho(dirs_l[p]) for p in range(nP)]
    wp_pho = [wpdf_p[p] * pho(dirs_p[p]) for p in range(nP)]

    for ws, dirs, ch, est in (
        (wl_lam, dirs_l, 0, est_d),
        (wp_lam, dirs_p, 1, est_d),
        (wl_pho, dirs_l, 0, est_s),
        (wp_pho, dirs_p, 1, est_s),
    ):
        r = _roulette(sc, counts, dirs, ws, hl, ho, pre, ch, nP)
        for c in range(3):
            est[c] = est[c] + r[c]
    return est_d, est_s


# ------------------------------------------------ the shade kernel (K4)

def dual_mis_plain(scene, gb, camera, seed, config):
    """K4's function as plain tensor ops → (est_d, est_s), each f32[H,W,3]:
    the shade core at hl = cam + rd·depth of the G-buffer `gb` with the
    per-pixel seed image `seed` (i32[H,W]), ONE sample on the raw seed
    whatever the smp counts (as the JAX kernel), zero where the pixel is a
    miss or the light."""
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk

    ops = fk.small_operands(scene, camera, 0)
    nK = int(scene.materials.s0.shape[0])
    sc = dict(zip(fk.SC_KEYS, ops[:17]), nK=nK)
    cam = ops[17]
    hn = tuple(gb.normal[..., k] for k in range(3))
    rd = tuple(gb.ray_dir[..., k] for k in range(3))
    ho = gb.obj_id
    hl = tuple(cam[0, k] + rd[k] * gb.depth for k in range(3))
    est_d, est_s = _shade_core(sc, fk._counts(scene), nK, config.gloss, hn, rd, ho, hl, seed,
                               soft_beta=float(config.soft_shadows))
    shade = (ho != sc["light_id_arr"][0, 0]) & (ho > 0)
    mask = lambda est: torch.stack([torch.where(shade, e, 0.0) for e in est], dim=-1)
    return mask(est_d), mask(est_s)


def dual_mis(scene, gb, camera, seed, config):
    """The dual-MIS estimator pair from a G-buffer → (est_d, est_s), each
    f32[H,W,3], masked to shaded pixels. CUDA tensors launch the shade
    kernel (or raise); CPU tensors run `dual_mis_plain`. Forward only: an
    input that requires grad raises (`shade_backend="xla"` differentiates)."""
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk

    fk.forward_only("the shade kernel (K4)", 'shade_backend="xla"', scene, camera, gb.normal, gb.depth,
                    gb.ray_dir, gb.curv)
    if gb.obj_id.device.type == "cpu":
        fk.check_planes_for_biased(scene, config)
        return dual_mis_plain(scene, gb, camera, seed, config)
    launch, out = dual_mis_launch(scene, gb, camera, seed, config)
    launch()
    return out


def dual_mis_launch(scene, gb, camera, seed, config):
    """`dual_mis`' CUDA route in two steps → (launch, (est_d, est_s)): the
    arguments are checked and the outputs allocated here; launch()
    launches K4 once into them and counts it. The kernel gathers the
    scene's tables from the scene's own tensors
    (`frame_kernel.table_parts`); nothing is packed.
    ops/adjoint_variants.py times launch() alone beside `dual_mis`."""
    from kylespathtracer_tpu_torch.ops import _build
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk

    fk.check_planes_for_biased(scene, config)
    device = gb.obj_id.device
    if device.type != "cuda":
        raise ValueError(f"dual_mis: unsupported device {device}")
    (nP, nS, nB, nK, _, _, _), (_, _, _, soft_beta, gloss) = fk.kernel_args(scene, camera, config)
    H, W = gb.obj_id.shape
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shape in (
        ("gb.normal", gb.normal, f32, (H, W, 3)), ("gb.obj_id", gb.obj_id, i32, (H, W)),
        ("gb.depth", gb.depth, f32, (H, W)), ("gb.ray_dir", gb.ray_dir, f32, (H, W, 3)),
        ("seed", seed, i32, (H, W)),
    ):
        _build.check_tensor(name, t, dt, shape, device)
    parts = fk.table_parts(scene, camera)
    est_d = torch.empty((H, W, 3), dtype=f32, device=device)
    est_s = torch.empty((H, W, 3), dtype=f32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    # launch() reads the tensors itself, so it keeps alive what the kernel
    # reads and writes after the caller has dropped them.
    def launch():
        global LAUNCHES
        io = _build.SHADE_IO.pack(*(t.data_ptr() for t in (
            gb.normal, gb.depth, gb.ray_dir, gb.obj_id, seed, est_d, est_s)))
        err = _build.load().kpt_dual_mis(fk.table_parts_struct(*parts), nP, nS, nB, nK, W, H, soft_beta, gloss,
                                         io, stream)
        _build.check(err, "kpt_dual_mis")
        LAUNCHES += 1

    return launch, (est_d, est_s)

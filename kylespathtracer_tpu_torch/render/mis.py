"""MIS-weighted light + surface sampling estimators.

Port of kylespathtracer_tpu/render/mis.py (reference: common.glsl:300-616):
the PDF strategies, the contribution estimators, DMIS/SMIS and their fused
pair `dual_mis`, and the unbiased brute-force estimators. The reference's
per-pixel roulette over four planes becomes: evaluate all P plane PDFs,
cumulative-sum a CDF, pick one plane per pixel with the shared Weyl draw,
gather that plane's parameters and run a single contribution march.

Plain tensor code (the pass pipeline's `shade_backend="xla"`); the
estimators take a `trace(scene, ro, rd, exclude)` callable
(render/passes.get_trace).
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.core import gmath, sampler
from kylespathtracer_tpu_torch.diff import softvis
from kylespathtracer_tpu_torch.scene import materials as mat_mod
from kylespathtracer_tpu_torch.scene.types import Scene

# ------------------------------------------------------------- PDFs


def sphere_light_pdf(hl, li, seed=None, pre=None):
    """Cone sample toward a sphere light → (dir[...,3], pdf[...])
    (reference: common.glsl:300-305)."""
    lv = li[:3] - hl
    dir_ = sampler.uniform_cone_dir(lv, li[3], seed, pre=pre)
    pdf = gmath.solid_angle(gmath.dot(lv, lv), li[3] * li[3])
    return dir_, pdf


def lambert_plane_pdf(hl, li, pl, seed=None, pre=None):
    """Cone sample toward the light's projection disc on a diffuse plane
    pl = (n, w) → (dir, pdf) (reference: common.glsl:308-322). Where the
    shaded point sits on the light's projection the pdf is 0."""
    n = pl[..., :3]
    w = pl[..., 3]
    d = li[:3] - n * (gmath.dot_k(li[:3].expand(n.shape), n) + w[..., None])
    dv = d - hl
    ld = li[:3] - d
    frad = torch.minimum(gmath.length(dv), gmath.length(ld)) * 0.9
    dir_ = sampler.uniform_cone_dir(dv, frad, seed, pre=pre)
    lpdf = gmath.solid_angle(gmath.dot(dv, dv), frad * frad) / gmath.PI
    g2pdf = gmath.lambertian(n, -dir_)
    ok = gmath.dot(dv, dv) > 1e-12
    return dir_, torch.where(ok, lpdf * g2pdf, 0.0)


def phong_plane_pdf(hl, li, pl, seed=None, pre=None):
    """Cone sample toward the light's mirror image in a glossy plane
    (reference: common.glsl:325-343); a+b ≈ 0 is guarded, a degenerate
    reflection point gets pdf 0."""
    n = pl[..., :3]
    w = pl[..., 3]
    a = gmath.dot(hl, n) + w
    b = gmath.dot(li[:3].expand(n.shape), n) + w
    ab = a + b
    ab = torch.where(ab.abs() < 1e-6, 1e-6, ab)
    s = gmath.mix(hl - a[..., None] * n, li[:3] - b[..., None] * n, (a / ab)[..., None])
    sv = s - hl
    lsv = torch.sqrt(gmath.dot(sv, sv)) * li[3]
    ls = li[:3] - s
    ts = sv * torch.sqrt(gmath.dot(ls, ls))[..., None]
    dir_ = sampler.uniform_cone_dir(ts, lsv, seed, pre=pre)
    lpdf = gmath.solid_angle(gmath.dot(ts, ts), lsv * lsv) / gmath.PI
    spdf = gmath.schlick(1.0, 3.0, gmath.dot(gmath.normalize(sv), n))
    ok = gmath.dot(sv, sv) > 1e-12
    return dir_, torch.where(ok, lpdf * spdf, 0.0)


# ----------------------------------------------------- contributions


def light_contribution(scene: Scene, trace, hl, ho, dir_, pdf):
    """March toward the light; lightColor·pdf on a hit, else 0 (the pdf
    multiplies; reference: common.glsl:348-353)."""
    _, lm_id = trace(scene, hl, dir_, ho)
    hit = lm_id == scene.light_id
    return torch.where(hit[..., None], scene.light_color * pdf[..., None], 0.0)


def plane_contrib(scene: Scene, trace, dir_, pdfw, hl, ho, pl, po, seed,
                  energy_channel: int, pre=None):
    """March to a sampled plane, verify the hit, re-sample the light there.
    energy_channel 0 → LambertPlaneContrib (common.glsl:356-371), 1 →
    PhongPlaneContrib (common.glsl:374-389)."""
    t, tid = trace(scene, hl, dir_, ho)
    ok = tid == po
    n = pl[..., :3]
    hl2 = hl + dir_ * t[..., None] + n * gmath.EPS
    lv2 = scene.light[:3] - hl2
    sample_dir = sampler.uniform_cone_dir(lv2, scene.light[3], seed, pre=pre)
    lc = light_contribution(scene, trace, hl2, po, sample_dir, pdfw)
    albedo, emission, energy = mat_mod.surface(scene.materials, po, hl2)
    contrib = emission + energy[..., energy_channel:energy_channel + 1] * albedo * lc
    return torch.where(ok[..., None], contrib, 0.0)


# ------------------------------------------------- strategies


def plane_pdfs(scene: Scene, pdf_fn, hl, seed=None, pre=None):
    """pdf_fn for every plane at once → (dirs[...,P,3], pdfs[...,P])."""
    hl_p = hl[..., None, :]
    if pre is not None:
        pre = tuple(c[..., None] for c in pre)
        return pdf_fn(hl_p, scene.light, scene.planes, None, pre=pre)
    return pdf_fn(hl_p, scene.light, scene.planes, seed[..., None])


def _select(scene: Scene, dirs, w, rnd_unit):
    """The roulette pick: weights → CDF → the first plane with
    rnd ≤ cdf (the last plane unconditional, common.glsl:475-482) →
    (dir, w, plane, id, total) of the chosen plane."""
    cdf = torch.cumsum(w, dim=-1)
    total = cdf[..., -1]
    rnd = rnd_unit * total
    idx = (rnd[..., None] > cdf[..., :-1]).sum(-1)
    dir_sel = torch.take_along_dim(dirs, idx[..., None, None], dim=-2)[..., 0, :]
    w_sel = torch.take_along_dim(w, idx[..., None], dim=-1)[..., 0]
    return dir_sel, w_sel, scene.planes[idx], scene.plane_ids[idx], total


def _roulette_from(scene: Scene, trace, dirs, pdfs, brdf_w, hl, ho, seed,
                   energy_channel: int, pre=None):
    """Indirect block from precomputed per-plane samples: weight → CDF →
    one-sample roulette → single contribution march
    (reference: common.glsl:453-519, 548-613)."""
    rnd_unit = pre[3] if pre is not None else sampler.weyl3(seed)[..., 2]
    dir_sel, w_sel, pl_sel, po_sel, total = _select(scene, dirs, pdfs * brdf_w(dirs), rnd_unit)
    contrib = plane_contrib(scene, trace, dir_sel, w_sel, hl, ho, pl_sel, po_sel, seed,
                            energy_channel, pre=pre)
    return contrib * (total / torch.clamp(w_sel, min=gmath.EPS))[..., None]


def _roulette_planes(scene: Scene, trace, pdf_fn, brdf_w, hl, ho, seed, energy_channel: int):
    """PDF evaluation + roulette in one call (the unfused estimators)."""
    dirs, pdfs = plane_pdfs(scene, pdf_fn, hl, seed)
    return _roulette_from(scene, trace, dirs, pdfs, brdf_w, hl, ho, seed, energy_channel)


def _roulette_select(scene: Scene, dirs, pdfs, brdf_w, pre):
    """The roulette pick of `_roulette_from` without the marches, so that
    `dual_mis` can batch the marches of all four strategies."""
    dir_sel, w_sel, pl_sel, po_sel, total = _select(scene, dirs, pdfs * brdf_w(dirs), pre[3])
    return {"dir": dir_sel, "w": w_sel, "total": total, "plane": pl_sel, "po": po_sel}


def _equal_smp(config) -> bool:
    return (config.smp_direct_lambert == config.smp_lambert_surface_lambert
            == config.smp_lambert_surface_phong == config.smp_direct_phong
            == config.smp_phong_surface_lambert == config.smp_phong_surface_phong)


def dual_mis(scene: Scene, trace, rd, hl, hn, ho, seed, config):
    """DMIS and SMIS fused → (diffuse_est, specular_est), each averaged over
    the smp samples. The per-plane cone samples are evaluated once, and the
    direct-light visibility and the four selected plane marches go through
    one batched trace, the four light re-samples through a second. Requires
    all six SMP_* counts equal (the passes fall back to dmis + smis)."""
    if not _equal_smp(config):
        raise ValueError("dual_mis requires equal sample counts; use dmis/smis")
    smp = config.smp_direct_lambert
    gloss = config.gloss
    lam = lambda dirs: torch.clamp((dirs * hn[..., None, :]).sum(-1), min=gmath.EPS)
    refl = gmath.reflect(rd, hn)[..., None, :]
    pho = lambda dirs: gmath.pow_static(torch.clamp((dirs * refl).sum(-1), min=gmath.EPS), gloss)

    est_d = torch.zeros(hl.shape, dtype=hl.dtype, device=hl.device)
    est_s = torch.zeros(hl.shape, dtype=hl.dtype, device=hl.device)
    for i in range(smp):
        pre = sampler.cone_pre(sampler.fold_seed(seed, i, config.decorrelate_samples))
        dl_dir, dl_pdf = sphere_light_pdf(hl, scene.light, pre=pre)
        dirs_l, pdfs_l = plane_pdfs(scene, lambert_plane_pdf, hl, pre=pre)
        dirs_p, pdfs_p = plane_pdfs(scene, phong_plane_pdf, hl, pre=pre)
        sels = [_roulette_select(scene, dirs, pdfs, brdf_w, pre) for dirs, pdfs, brdf_w in (
            (dirs_l, pdfs_l, lam), (dirs_p, pdfs_p, lam), (dirs_l, pdfs_l, pho), (dirs_p, pdfs_p, pho))]

        # Stage A: direct-light visibility + the 4 selected plane marches.
        dirs_a = torch.stack([dl_dir] + [s["dir"] for s in sels], dim=0)
        t_a, id_a = trace(scene, hl.expand(dirs_a.shape), dirs_a, ho.expand(dirs_a.shape[:-1]))

        if config.soft_shadows > 0.0:
            # Smooth sphere occlusion; a plane, a box or a miss as the
            # nearest hit still gives zero visibility.
            dist = gmath.length(scene.light[:3] - hl)
            t_surf = torch.clamp(dist - scene.light[3], min=gmath.EPS)
            vis = softvis.sphere_soft_transmittance(scene, hl, dl_dir, t_surf, ho, config.soft_shadows)
            sphere_or_light = (id_a[0][..., None] == scene.sphere_ids).any(-1)
            base = scene.light_color * torch.where(sphere_or_light, vis, 0.0)[..., None]
        else:
            base = torch.where((id_a[0] == scene.light_id)[..., None], scene.light_color, 0.0)
        est_d = est_d + base * (dl_pdf * gmath.lambertian(hn, dl_dir))[..., None]
        est_s = est_s + base * (dl_pdf * gmath.phong(rd, hn, dl_dir, gloss))[..., None]

        # Stage B: the 4 light re-samples from the sampled-plane points.
        hl2s, sdirs = [], []
        for k, s in enumerate(sels):
            hl2 = hl + s["dir"] * t_a[k + 1][..., None] + s["plane"][..., :3] * gmath.EPS
            hl2s.append(hl2)
            sdirs.append(sampler.uniform_cone_dir(scene.light[:3] - hl2, scene.light[3], pre=pre))
        ro_b = torch.stack(hl2s, dim=0)
        _, id_b = trace(scene, ro_b, torch.stack(sdirs, dim=0), torch.stack([s["po"] for s in sels], dim=0))

        for k, (s, ch, diffuse) in enumerate(
                ((sels[0], 0, True), (sels[1], 1, True), (sels[2], 0, False), (sels[3], 1, False))):
            ok = id_a[k + 1] == s["po"]
            lhit = id_b[k] == scene.light_id
            lc = torch.where(lhit[..., None], scene.light_color * s["w"][..., None], 0.0)
            albedo, emission, energy = mat_mod.surface(scene.materials, s["po"], ro_b[k])
            contrib = torch.where(ok[..., None], emission + energy[..., ch:ch + 1] * albedo * lc, 0.0)
            contrib = contrib * (s["total"] / torch.clamp(s["w"], min=gmath.EPS))[..., None]
            if diffuse:
                est_d = est_d + contrib
            else:
                est_s = est_s + contrib
    return est_d / smp, est_s / smp


def _averaged(n: int, sample):
    """Σ_{i<n} sample(i) / n, accumulated from 0.0 as the JAX code does."""
    acc = 0.0
    for i in range(n):
        acc = acc + sample(i)
    return acc / n


def dmis(scene: Scene, trace, hl, hn, ho, seed, config):
    """Diffuse MIS: direct light + roulette over Lambert/Phong plane
    strategies, Lambertian-weighted (reference: common.glsl:430-522)."""
    ret = torch.zeros(hl.shape, dtype=hl.dtype, device=hl.device)
    lam = lambda dirs: torch.clamp((dirs * hn[..., None, :]).sum(-1), min=gmath.EPS)
    fold = lambda i: sampler.fold_seed(seed, i, config.decorrelate_samples)

    def direct(i):
        dl_dir, dl_pdf = sphere_light_pdf(hl, scene.light, fold(i))
        return light_contribution(scene, trace, hl, ho, dl_dir, dl_pdf * gmath.lambertian(hn, dl_dir))

    if config.smp_direct_lambert:
        ret = ret + _averaged(config.smp_direct_lambert, direct)
    if config.smp_lambert_surface_lambert:
        ret = ret + _averaged(config.smp_lambert_surface_lambert, lambda i: _roulette_planes(
            scene, trace, lambert_plane_pdf, lam, hl, ho, fold(i), 0))
    if config.smp_lambert_surface_phong:
        ret = ret + _averaged(config.smp_lambert_surface_phong, lambda i: _roulette_planes(
            scene, trace, phong_plane_pdf, lam, hl, ho, fold(i), 1))
    return ret


def smis(scene: Scene, trace, rd, hl, hn, ho, seed, config):
    """Specular MIS: the same three blocks Phong-weighted
    (reference: common.glsl:525-616)."""
    ret = torch.zeros(hl.shape, dtype=hl.dtype, device=hl.device)
    gloss = config.gloss
    refl = gmath.reflect(rd, hn)[..., None, :]
    pho = lambda dirs: gmath.pow_static(torch.clamp((dirs * refl).sum(-1), min=gmath.EPS), gloss)
    fold = lambda i: sampler.fold_seed(seed, i, config.decorrelate_samples)

    def direct(i):
        dl_dir, dl_pdf = sphere_light_pdf(hl, scene.light, fold(i))
        return light_contribution(scene, trace, hl, ho, dl_dir,
                                  dl_pdf * gmath.phong(rd, hn, dl_dir, gloss))

    if config.smp_direct_phong:
        ret = ret + _averaged(config.smp_direct_phong, direct)
    if config.smp_phong_surface_lambert:
        ret = ret + _averaged(config.smp_phong_surface_lambert, lambda i: _roulette_planes(
            scene, trace, lambert_plane_pdf, pho, hl, ho, fold(i), 0))
    if config.smp_phong_surface_phong:
        ret = ret + _averaged(config.smp_phong_surface_phong, lambda i: _roulette_planes(
            scene, trace, phong_plane_pdf, pho, hl, ho, fold(i), 1))
    return ret


# ---------------------------------------------- one-bounce BRDF mutators


def brdf_lambertian(hl, hn, seed):
    """Next-bounce ray for a diffuse surface → (ro, rd): origin offset along
    the normal, cosine-hemisphere direction (reference: common.glsl:418-421)."""
    return hl + hn * gmath.EPS, sampler.cos_hemi_dir(hn, seed)


def brdf_phong(rd, hl, hn):
    """Next-bounce ray for a specular surface → (ro, rd): mirror reflection
    (reference: common.glsl:424-427)."""
    return hl + hn * gmath.EPS, gmath.reflect(rd, hn)


# ------------------------------------------------- unbiased ground truth


def unbiased_lambertian(scene: Scene, trace, hl, hn, ho, seed, config):
    """Cosine-hemisphere brute force (reference: common.glsl:394-403)."""
    pdf = torch.full(hl.shape[:-1], gmath.PI, dtype=hl.dtype, device=hl.device)
    return _averaged(config.smp_direct_lambert, lambda i: light_contribution(
        scene, trace, hl, ho,
        sampler.cos_hemi_dir(hn, sampler.fold_seed(seed, i, config.decorrelate_samples)), pdf))


def unbiased_phong(scene: Scene, trace, rd, hl, hn, ho, seed, config):
    """Mirror-reflection brute force (reference: common.glsl:406-415); the
    loop count reuses SMP_DIRECT_LAMBERT, as upstream does."""
    one = torch.ones(hl.shape[:-1], dtype=hl.dtype, device=hl.device)
    return _averaged(config.smp_direct_lambert, lambda i: light_contribution(
        scene, trace, hl, ho, gmath.reflect(rd, hn), one))

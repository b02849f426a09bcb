"""BSDF evaluation and sampling for the multi-bounce wavefront integrator.

Port of kylespathtracer_tpu/render/bsdf.py: four single-lobe BSDFs —
DIFFUSE (Lambertian), GLOSSY (normalized Phong around the mirror
direction), MIRROR and DIELECTRIC (Schlick-Fresnel glass) — evaluated for
every pixel and selected by its kind with `torch.where`.

Conventions: `wo` points away from the surface toward the camera
(wo = -rd), `wi` away from the surface toward the next vertex; `n` is the
shading normal flipped to face the incoming ray.
"""

from __future__ import annotations

import torch

from kylespathtracer_tpu_torch.core import gmath
from kylespathtracer_tpu_torch.scene.types import BSDF

_INV_PI = 1.0 / gmath.PI
_DELTA_PDF = 1e8  # stand-in pdf for delta lobes (never used to divide)


def _cos(n, w):
    return torch.clamp(gmath.dot(n, w), min=0.0)


def eval_pdf(kind, rho_d, rho_s, n, wo, wi, gloss):
    """(f(wo,wi)·cosθi [...,3], pdf(wi) [...]) of the non-delta lobes; the
    delta lobes (MIRROR, DIELECTRIC) give 0, out of reach of NEE."""
    ci = _cos(n, wi)
    f_d = rho_d * (_INV_PI * ci)[..., None]
    pdf_d = ci * _INV_PI

    refl = gmath.reflect(-wo, n)
    ca = torch.clamp(gmath.dot(refl, wi), min=0.0)
    ca_g = gmath.pow_static(ca, gloss)
    f_g = rho_s * ((gloss + 2.0) / gmath.TWOPI * ca_g * ci)[..., None]
    pdf_g = (gloss + 1.0) / gmath.TWOPI * ca_g

    is_g = kind == BSDF.GLOSSY
    is_delta = kind >= BSDF.MIRROR
    f = torch.where(is_g[..., None], f_g, f_d)
    pdf = torch.where(is_g, pdf_g, pdf_d)
    zero = is_delta | (ci <= 0.0)
    return torch.where(zero[..., None], 0.0, f), torch.where(zero, 0.0, pdf)


def sample(kind, rho_d, rho_s, ior, n, wo, gloss, u1, u2, u3):
    """Sample an outgoing direction → (wi[...,3], weight[...,3] = f·cosθ/pdf,
    pdf[...], is_delta[...], transmit[...]). `ior` is the relative eta of
    the medium being entered (the caller inverts it on the way in)."""
    f, r = gmath.basis(n)
    phi = gmath.TWOPI * u2
    cp, sp = torch.cos(phi), torch.sin(phi)

    # DIFFUSE: cosine-weighted hemisphere.
    srt = torch.sqrt(u1)
    x = srt * cp
    y = srt * sp
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    wi_d = f * x[..., None] + r * y[..., None] + n * z[..., None]
    pdf_d = z * _INV_PI

    # GLOSSY: power-cosine lobe around the mirror direction.
    refl = gmath.reflect(-wo, n)
    fg, rg = gmath.basis(refl)
    ca = u1 ** (1.0 / (gloss + 1.0))
    sa = torch.sqrt(torch.clamp(1.0 - ca * ca, min=0.0))
    wi_g = fg * (sa * cp)[..., None] + rg * (sa * sp)[..., None] + refl * ca[..., None]
    ci_g = gmath.dot(n, wi_g)
    w_g = rho_s * torch.clamp((gloss + 2.0) / (gloss + 1.0) * ci_g, min=0.0)[..., None]
    pdf_g = (gloss + 1.0) / gmath.TWOPI * gmath.pow_static(ca, gloss)

    # DIELECTRIC: Schlick-Fresnel reflect/refract with total internal
    # reflection; selecting by the Fresnel probability cancels F/(1-F).
    ci = torch.clamp(gmath.dot(n, wo), min=1e-6)
    eta = ior
    sin2t = eta * eta * torch.clamp(1.0 - ci * ci, min=0.0)
    tir = sin2t > 1.0
    cost = torch.sqrt(torch.clamp(1.0 - sin2t, min=1e-9))
    r0 = (eta - 1.0) / (eta + 1.0)
    r0 = r0 * r0
    u = 1.0 - ci
    u2_ = u * u
    fres = r0 + (1.0 - r0) * (u2_ * u2_ * u)
    take_refl = u3 < torch.where(tir, 1.0, fres)
    wi_t = gmath.normalize_fast((-wo) * eta[..., None] + n * (eta * ci - cost)[..., None])
    wi_x = torch.where(take_refl[..., None], refl, wi_t)

    is_g = kind == BSDF.GLOSSY
    is_m = kind == BSDF.MIRROR
    is_x = kind == BSDF.DIELECTRIC
    is_delta = is_m | is_x

    wi = torch.where(is_x[..., None], wi_x, torch.where(
        is_m[..., None], refl, torch.where(is_g[..., None], wi_g, wi_d)))
    # MIRROR and DIELECTRIC carry the full reflectance tint rho_d + rho_s.
    weight = torch.where(is_delta[..., None], rho_d + rho_s,
                         torch.where(is_g[..., None], w_g, rho_d))
    pdf = torch.where(is_delta, _DELTA_PDF, torch.where(is_g, pdf_g, pdf_d))
    transmit = is_x & ~take_refl
    return wi, weight, pdf, is_delta, transmit

"""Shared rasterisation math: projection, texture sampling, shading.

Counterpart of ``depthrenderer_tpu/ops/common.py``. Conventions (the
reference's OpenGL semantics): ``clip = MVP @ [x, y, z, 1]``; the viewport
maps NDC [-1, 1] to [0, W] x [0, H] with y up; output images are top-down, so
pixel (row i, col j) has window centre (j + 0.5, H - i - 0.5); background is
black with alpha 255; texels are quantised to 8 bits before bilinear,
clamp-to-edge filtering with GL's half-texel rule.

Float expressions follow the JAX package's order of operations, so the same
inputs give the same bits on the CPU and on the GPU, and the projection's bits
equal the JAX package's on its CPU backend.
"""

from __future__ import annotations

import torch

# Depth of uncovered pixels: loses every depth test (valid NDC z <= 1).
FAR_SENTINEL = 3.0e38

_F32 = torch.float32


def const(x, like):
    """A float32 scalar on ``like``'s device, filled there (no host copy, so
    no wait on the stream). Dividing by it is a true division on every
    device (CUDA divides by a host scalar as a multiply by its
    reciprocal)."""
    return torch.full((), x, dtype=_F32, device=like.device)


def fma(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add (CUDA's
    ``fmaf``) rounds it, on any device.

    The float32 product is exact in float64; the float64 sum is made
    round-to-odd (its error, from Knuth's two-sum, nudges an even result one
    ulp towards the exact value), and rounding a round-to-odd value with 29
    spare bits to float32 is the correctly rounded result.
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(_F32)


def project_vertices(vertices, mvp, width, height):
    """Project model-space vertices to window coordinates.

    :param vertices: (..., 3) float32 positions.
    :param mvp: (4, 4) or (T, 4, 4) float32 model-view-projection matrices.
    :return: ``(sx, sy, z_ndc, inv_w)``, each shaped ``mvp.shape[:-2] +
        vertices.shape[:-1]``: window x/y (y up), NDC depth and 1/clip_w.

    Rounded as the JAX package's batched scan prep rounds on XLA's CPU
    backend: ``clip_j = ((v0 m_j0 + v1 m_j1) + v2 m_j2) + m_j3`` as separate
    float32 operations, then ``sx = fma(clip_x, 1/w, 1) * (W/2)``. One ulp
    of sy moves a crossing across a scanline, and with it the prep's
    integers.
    """
    vertices = torch.as_tensor(vertices, dtype=_F32)
    mvp = torch.as_tensor(mvp, dtype=_F32, device=vertices.device)
    lead = mvp.shape[:-2]
    vdims = vertices.dim() - 1
    m = mvp.reshape(lead + (1,) * vdims + (4, 4))
    v0, v1, v2 = vertices[..., 0], vertices[..., 1], vertices[..., 2]
    clip = [((v0 * m[..., j, 0] + v1 * m[..., j, 1]) + v2 * m[..., j, 2])
            + m[..., j, 3] for j in range(4)]
    w = clip[3]
    inv_w = torch.where(w.abs() > 1e-20, torch.ones_like(w) / w,
                        torch.zeros_like(w))
    one = torch.ones_like(inv_w)
    sx = fma(clip[0], inv_w, one) * (0.5 * width)
    sy = fma(clip[1], inv_w, one) * (0.5 * height)
    return sx, sy, clip[2] * inv_w, inv_w


def quantise_texture(texture):
    """(Ht, Wt, C) float or uint8 texels -> float32 rounded to 8 bits
    (the uploaded RGBA8 texels GL filters)."""
    t = torch.as_tensor(texture).to(_F32)
    return torch.clamp(torch.round(t), 0.0, 255.0)


def sample_texture_bilinear(texture, u, v):
    """Bilinear, clamp-to-edge sample of 8-bit-quantised texels.

    :param texture: (Ht, Wt, C) texels (float in 0..255, or uint8).
    :param u, v: texture coordinates of one shape; ``v = 1`` samples row 0.
    :return: (..., C) float32 samples.
    """
    tex = quantise_texture(texture)
    ht, wt = tex.shape[0], tex.shape[1]
    tx = torch.clamp(u * wt - 0.5, 0.0, wt - 1.0)
    ty = torch.clamp((1.0 - v) * ht - 0.5, 0.0, ht - 1.0)
    x0f = torch.floor(tx)
    y0f = torch.floor(ty)
    fx = (tx - x0f)[..., None]
    fy = (ty - y0f)[..., None]
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = torch.clamp(x0 + 1, max=wt - 1)
    y1 = torch.clamp(y0 + 1, max=ht - 1)
    c00, c01 = tex[y0, x0], tex[y0, x1]
    c10, c11 = tex[y1, x0], tex[y1, x1]
    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    return top + (bot - top) * fy


def shade(covered, u, v, z_model, texture, mode: str):
    """Fragment shading -> (..., 4) uint8: ``texture`` (the reference's
    ``shader.frag``) or ``debug_z`` (grey model z, texture alpha), with the
    black, alpha-255 background where uncovered."""
    tex = sample_texture_bilinear(texture, u, v)
    if mode == "texture":
        rgba = tex
    elif mode == "debug_z":
        grey = torch.clamp(z_model, 0.0, 1.0) * 255.0
        rgba = torch.stack([grey, grey, grey, tex[..., 3]], dim=-1)
    else:
        raise ValueError(f"Unknown shading mode {mode!r}")
    background = torch.tensor([0.0, 0.0, 0.0, 255.0], dtype=_F32,
                              device=rgba.device)
    out = torch.where(covered[..., None], rgba, background)
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)

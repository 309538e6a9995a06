"""The kernels' rooflines: the least time the card could take for a
frame's work, from counts of the work itself, never from a kernel's
arguments or the port's plain versions.

The counts come from the plain reference's render of the same frame
(render.render(count=True)): the pixels, the covered pixels, the distinct
texels they read, the triangles and lights of the scene, the reflection
rays cast, and for each ray the triangle boxes its segment up to its hit
crosses. The per-item constants were counted from the expressions of the
renderer's equations (chip_smoke.py's OPS_*, frozen here): every multiply,
add, subtract, divide, square root, floor, exp, min/max and compare is one
f32 operation.

The bound is the larger of the bytes over the HBM rate and the f32
operations over the f32 rate (NVIDIA's published H100 SXM peaks at 700 W);
the card's power limit goes beside every share."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# B1: a covered pixel's coverage and depth test against its winner (three
# edge planes and the depth plane, a multiply and an add each), the
# interpolation, the nearest texel, the fixed shading (view and world
# position, view and normal directions, albedo, hemisphere ambient, batch
# ambient, sRGB encode, fullbright blend, fog, quantize)
OPS_VIS_TEST = 8
OPS_INTERP = 30
OPS_TEXEL_NEAREST = 43
OPS_SHADE_FIXED = 204
OPS_SUN_EXTRA = 6
# one light of a type (0 point, 1 and 2 ambient, 3 spot) up to its radiance
# and the accumulation, and one GGX BRDF evaluation
OPS_PER_LIGHT = {0: 54, 1: 34, 2: 34, 3: 61}
OPS_BRDF_GGX = 94
# B1's data: a triangle's screen planes (three edges, depth, u/w, v/w,
# 1/w and the normal's three: 10 planes of 3 floats) and its batch's
# fields (kind, repeat, normals flag, RGBA, ambient RGB, texture rect:
# 14 floats); a light's 24 floats; a texel's RGBA8; each pixel's RGBA8
# and depth written once
B1_TRIANGLE_BYTES = (10 * 3 + 14) * 4
LIGHT_BYTES = 24 * 4
TEXEL_BYTES = 4
B1_PIXEL_OUT_BYTES = 4 + 4

# B3's walk: a Möller-Trumbore test (9 + 5 + 1 + 3 + 6 + 9 + 6 + 1 + 6
# f32 operations); a ray's origin and direction read, its t and triangle
# written; a triangle's vertex and two edges
OPS_MT_TEST = 46
RAY_BYTES = 6 * 4 + 2 * 4
WALK_TRIANGLE_BYTES = 9 * 4


def bound_ms(nbytes: float, ops: float) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the f32 rate, in ms."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def b1_bound_ms(work: dict, light_types: list, sun: bool) -> float:
    """The least time of the opaque frame's kernel (B1) on a frame's
    work: each covered pixel tested once against its winner and shaded
    with the frame's lights, sun and GGX BRDF."""
    per_px = OPS_VIS_TEST + OPS_INTERP + OPS_TEXEL_NEAREST + OPS_SHADE_FIXED
    if sun:
        per_px += OPS_BRDF_GGX + OPS_SUN_EXTRA
    per_px += sum(OPS_PER_LIGHT[t] + OPS_BRDF_GGX for t in light_types)
    nbytes = (work["pixels"] * B1_PIXEL_OUT_BYTES + work["triangles"] * B1_TRIANGLE_BYTES
              + work["lights"] * LIGHT_BYTES + work["texels"] * TEXEL_BYTES)
    return bound_ms(nbytes, work["covered"] * per_px)


def walk_bound_ms(work: dict) -> float:
    """The least time of the ray walks (B3) of a frame's work: every
    triangle whose box a ray's segment up to its hit crosses is tested
    once (any box-based structure tests at least those); the rays of all
    the frame's reflection passes."""
    nbytes = work["rays"] * RAY_BYTES + work["triangles"] * WALK_TRIANGLE_BYTES
    return bound_ms(nbytes, work["ray_boxes"] * OPS_MT_TEST)

"""Pixel/color substrate.

TPU-native port of the reference's fixed RGBA8 color space helpers
(reference: src/lib.rs:50-79 `Pixel`, `pixel_to_vec4`, `vec4_to_pixel`;
src/rasterizer.rs:19-33 fast sRGB polynomials; src/rasterizer.rs:185-208
`hash_u32` animation hash).

All functions are pure and work on numpy arrays or torch tensors (they
only use operators + the module passed math functions), so the same code
path is used host-side (asset baking) and device-side (shading).
"""

from __future__ import annotations

import numpy as np

INV_255 = 1.0 / 255.0

TRANSPARENT = (0, 0, 0, 0)
BLACK = (0, 0, 0, 255)
WHITE = (255, 255, 255, 255)


def srgb_to_linear_fast(x):
    """Approximate pow(x, 2.2): (0.6975*x^2 + 0.3025)*x.

    Matches the polynomial fit used by the reference renderer
    (src/rasterizer.rs:19-25, max abs error ~0.008)."""
    return (0.6975 * x * x + 0.3025) * x


def linear_to_srgb_fast(x):
    """Approximate pow(x, 1/2.2): 1.055*sqrt(x) - 0.055*x.

    Matches src/rasterizer.rs:27-33 (1.055*sqrt(x) - 0.055*sqrt(x)^2)."""
    # note: sqrt(x)*sqrt(x) == x for x >= 0
    if isinstance(x, np.ndarray) or np.isscalar(x):
        s = np.sqrt(np.maximum(x, 0.0))
    else:  # torch tensor
        import torch

        s = torch.sqrt(torch.clamp(x, min=0.0))
    return 1.055 * s - 0.055 * (s * s)


def tonemap_scenevm(x):
    """The SceneVM display transform: Reinhard + gamma 2.2
    (embedded/shader/3d_shader.wgsl:871-873:
    c = c/(c+1); pow(c, 1/2.2)). Works on numpy arrays or torch tensors."""
    if isinstance(x, np.ndarray) or np.isscalar(x):
        t = np.maximum(x, 0.0)
        return np.power(t / (t + 1.0), 1.0 / 2.2)
    import torch

    t = torch.clamp(x, min=0.0)
    return torch.pow(t / (t + 1.0), 1.0 / 2.2)


def tonemap_scenevm_inverse(e):
    """Numerical inverse of tonemap_scenevm (for linear-space composites
    on already-encoded frames): t = e^2.2; t/(1-t)."""
    import torch

    t = torch.pow(torch.clamp(e, 0.0, 1.0), 2.2)
    return t / torch.clamp(1.0 - t, min=1e-6)


#: dense inverse table of srgb_to_linear_fast for bake-time encoding
#: (built lazily: 8193-point linear interp of the strictly increasing
#: cubic is exact to ~1e-9 — far under the u8 quantization step)
_SRGB_INV_TABLE = None


def linear_to_srgb_exact_inverse(linear):
    """Encode LINEAR values for storage in u8 textures that the samplers
    decode with srgb_to_linear_fast — the numerical inverse of that exact
    cubic, so bake -> sample round-trips to within quantization.

    The reference bakes shader tiles with pow(x, 0.4545)
    (rusteria/src/renderbuffer.rs:88-107 to_u8_vec_gamma) and decodes with
    its fast polynomial — an approximate pair. Inverting our own sampler's
    polynomial instead keeps the intent (store sRGB) with a tighter round
    trip. numpy only (host bake path)."""
    global _SRGB_INV_TABLE
    if _SRGB_INV_TABLE is None:
        s = np.linspace(0.0, 1.0, 8193, dtype=np.float64)
        _SRGB_INV_TABLE = (s, srgb_to_linear_fast(s))
    s_grid, f_grid = _SRGB_INV_TABLE
    return np.interp(
        np.clip(np.asarray(linear, np.float64), 0.0, 1.0), f_grid, s_grid
    ).astype(np.float32)


def pixel_to_vec4(pixel):
    """RGBA8 -> float4 in [0,1] (src/lib.rs:53-61)."""
    return np.asarray(pixel, dtype=np.float32) * np.float32(INV_255)


def f32_to_u8_saturated(x):
    """clamp(x,0,1)*255+0.5, truncated (src/lib.rs:63-68)."""
    y = np.clip(np.asarray(x, dtype=np.float32), 0.0, 1.0) * 255.0 + 0.5
    return y.astype(np.int32).astype(np.uint8)


def vec4_to_pixel(vec):
    """float4 in [0,1] -> RGBA8 (src/lib.rs:70-79)."""
    return f32_to_u8_saturated(vec)


def hash_u32(seed: int) -> int:
    """Animation-frame hash used for light flicker (src/rasterizer.rs:199-208)."""
    mask = 0xFFFFFFFF
    state = seed & mask
    state = ((state ^ 61) ^ (state >> 16)) & mask
    state = (state + (state << 3)) & mask
    state ^= state >> 4
    state = (state * 0x27D4EB2D) & mask
    state ^= state >> 15
    return state


def rgb_to_hsl(rgb):
    """RGB [0,1] -> (h, s, l) each in [0,1] (TheColor::as_hsl semantics)."""
    r, g, b = (float(c) for c in np.asarray(rgb, np.float32)[:3])
    mx, mn = max(r, g, b), min(r, g, b)
    l = 0.5 * (mx + mn)
    if mx == mn:
        return 0.0, 0.0, l
    d = mx - mn
    s = d / (2.0 - mx - mn) if l > 0.5 else d / (mx + mn)
    if mx == r:
        h = (g - b) / d + (6.0 if g < b else 0.0)
    elif mx == g:
        h = (b - r) / d + 2.0
    else:
        h = (r - g) / d + 4.0
    return h / 6.0, s, l


def hsl_to_rgb(h, s, l):
    """(h, s, l) in [0,1] -> RGB [0,1] (TheColor::from_hsl semantics)."""
    if s == 0.0:
        return np.array([l, l, l], np.float32)

    def hue(p, q, t):
        t = t % 1.0
        if t < 1 / 6:
            return p + (q - p) * 6.0 * t
        if t < 1 / 2:
            return q
        if t < 2 / 3:
            return p + (q - p) * (2 / 3 - t) * 6.0
        return p

    q = l * (1.0 + s) if l < 0.5 else l + s - l * s
    p = 2.0 * l - q
    return np.array(
        [hue(p, q, h + 1 / 3), hue(p, q, h), hue(p, q, h - 1 / 3)], np.float32
    )


def hsl_to_rgb_many(h, s, l):
    """Vectorized hsl_to_rgb: h/s/l broadcastable arrays -> (..., 3) f32."""
    h = np.asarray(h, np.float32)
    s = np.asarray(s, np.float32)
    l = np.asarray(l, np.float32)
    h, s, l = np.broadcast_arrays(h, s, l)

    q = np.where(l < 0.5, l * (1.0 + s), l + s - l * s)
    p = 2.0 * l - q

    def hue(t):
        t = np.mod(t, 1.0)
        return np.where(
            t < 1 / 6,
            p + (q - p) * 6.0 * t,
            np.where(
                t < 1 / 2,
                q,
                np.where(t < 2 / 3, p + (q - p) * (2 / 3 - t) * 6.0, p),
            ),
        )

    rgb = np.stack([hue(h + 1 / 3), hue(h), hue(h - 1 / 3)], axis=-1)
    gray = np.broadcast_to(l[..., None], rgb.shape)
    return np.where(s[..., None] == 0.0, gray, rgb).astype(np.float32)

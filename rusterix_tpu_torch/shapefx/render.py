"""Sky / Fog render hooks — vectorized over the whole frame (torch
counterpart of `rusterix_tpu/shapefx/render.py`).

Exact ports of the reference node math (src/shapestack/shapefx.rs:935-1224):
sun arc + day factor from hour, day/night horizon/zenith lerp, haze, sun
glare disc, perlin cloud layer, distance fog. The set-up functions
(`sky_setup`, `fog_setup`, `sky_ambient_color`) are the JAX package's numpy
code; the per-pixel functions (`sky_miss`, `fog_apply`) are torch tensor
expressions over the whole frame, written in the rounding the JAX
package's CPU build (XLA) gives them where a last bit decides a discrete
outcome (the cloud texel)."""

from __future__ import annotations

import numpy as np

import torch

from ..device import device_const
from ..shader.patterns import pattern_bank
from ..utils.color import linear_to_srgb_fast


def _smoothstep_transition(hour: float) -> float:
    """shapefx.rs:937-950."""
    dawn_t = min(max(hour - 6.0, 0.0), 2.0) / 2.0
    dawn = dawn_t * dawn_t * (3.0 - 2.0 * dawn_t)
    dusk_t = min(max(20.0 - hour, 0.0), 2.0) / 2.0
    dusk = dusk_t * dusk_t * (3.0 - 2.0 * dusk_t)
    if hour < 6.0:
        return 0.0
    if hour < 8.0:
        return dawn
    if hour < 18.0:
        return 1.0
    if hour < 20.0:
        return dusk
    return 0.0


def sky_setup(node, hour: float):
    """shapefx.rs:971-1057 — precompute sun + palette; returns
    (sun_dir, day_factor)."""
    sunrise, sunset = 6.0, 20.0
    t_day = min(max((hour - sunrise) / (sunset - sunrise), 0.0), 1.0)
    theta = t_day * np.pi
    sun_dir = np.array([np.cos(theta), np.sin(theta), 0.0], np.float32)
    day_factor = _smoothstep_transition(hour)

    node.precomputed = [
        np.array([sun_dir[0], sun_dir[1], sun_dir[2], day_factor], np.float32),
        # haze: lerp(night, day, day_factor)
        (
            np.array([0.1, 0.1, 0.15, 0.0], np.float32) * (1 - day_factor)
            + np.array([0.3, 0.3, 0.35, 0.0], np.float32) * day_factor
        ),
        np.asarray(
            node.values.get_vec("day_horizon", (0.87, 0.80, 0.70, 1.0)), np.float32
        ),
        np.asarray(
            node.values.get_vec("day_zenith", (0.36, 0.62, 0.98, 1.0)), np.float32
        ),
        np.asarray(
            node.values.get_vec("night_horizon", (0.03, 0.04, 0.08, 1.0)), np.float32
        ),
        np.asarray(
            node.values.get_vec("night_zenith", (0.00, 0.01, 0.05, 1.0)), np.float32
        ),
    ]
    return sun_dir, day_factor


def fog_setup(node):
    """shapefx.rs:957-969."""
    node.precomputed = [
        np.asarray(node.values.get_vec("fog_color", (0.0, 0.0, 0.0, 0.0)), np.float32),
        np.array(
            [
                node.values.get_float_default("fog_end_distance", 30.0),
                max(node.values.get_float_default("fog_fade_out", 20.0), 1.0),
                0.0,
                0.0,
            ],
            np.float32,
        ),
    ]


def sky_ambient_color(node):
    """shapefx.rs:1086-1119."""
    if not node.precomputed:
        sky_setup(node, 12.0)
    day_factor = float(node.precomputed[0][3])
    day_avg = (node.precomputed[2] + node.precomputed[3]) * 0.5
    night_avg = (node.precomputed[4] + node.precomputed[5]) * 0.5
    c = night_avg * (1 - day_factor) + day_avg * day_factor
    out = np.asarray(
        linear_to_srgb_fast(np.maximum(c[:3], 0.2)), np.float32
    )
    return np.array([out[0], out[1], out[2], 1.0], np.float32)


def _f32(x, device):
    return device_const(np.asarray(x, np.float32), device)


def cloud_uv(ray_dir, cam):
    """Where each ray meets the cloud layer at 1500 units, in pattern-bank
    coordinates -> (u, v, t_hit); t_hit is -1 for rays that do not climb.
    The texel the layer samples is a discrete outcome: the products XLA
    fuses are fused (`cam + d*t`), and the numerator is divided as a tensor
    (a Python number over a tensor is a reciprocal times the number in
    torch)."""
    from ..ops.setup_pass import _fma

    dy = ray_dir[..., 1]
    t_hit = torch.where(dy > 0.0, (1500.0 - cam[1]) / torch.where(dy > 0, dy, 1.0), -1.0)
    hit_x = _fma(ray_dir[..., 0], t_hit, cam[0])
    hit_z = _fma(ray_dir[..., 2], t_hit, cam[2])
    return hit_x * 0.0005, hit_z * 0.0005, t_hit


def _cam_tensor(cam_pos, device):
    if torch.is_tensor(cam_pos):
        return cam_pos.to(device=device, dtype=torch.float32)
    return device_const(np.asarray(cam_pos, np.float32), device)


def sky_miss(sky_pre, ray_dir, cam_pos):
    """Vectorized render_miss_d3 for the Sky node (shapefx.rs:1122-1224).

    sky_pre: dict of tensors from sky_device_params; ray_dir: (..., 3) f32
    tensor; cam_pos: (3,) f32 (numpy or a tensor). Returns (..., 4) color."""
    from ..ops.setup_pass import _fma
    from ..shader.patterns import PATTERN_NAMES, sample_pattern_jnp

    dev = ray_dir.device
    cam = _cam_tensor(cam_pos, dev)
    sun_data = sky_pre["sun"]
    sun_dir = sun_data[:3]
    day_factor = sun_data[3]

    up = torch.clamp(ray_dir[..., 1], -1.0, 1.0)
    t = ((up + 1.0) * 0.5)[..., None]

    nh, nz = sky_pre["night_horizon"], sky_pre["night_zenith"]
    dh, dz = sky_pre["day_horizon"], sky_pre["day_zenith"]
    night = _fma(nz - nh, t, nh)
    day = _fma(dz - dh, t, dh)
    color = _fma(night, 1.0 - day_factor, day * day_factor)

    # atmospheric haze
    one_up = 1.0 - up
    haze = one_up * one_up * one_up
    fog = sky_pre["haze"] * haze[..., None] * 0.3
    color = _fma(color, 1.0 - haze[..., None] * 0.2, fog)

    # sun glare disc
    dot = torch.clamp(_fma(ray_dir[..., 2], sun_dir[2],
                           _fma(ray_dir[..., 1], sun_dir[1], ray_dir[..., 0] * sun_dir[0])),
                      -1.0, 1.0)
    dist = torch.clamp(1.0 - dot, min=0.0)
    sun_radius = 0.04
    k = torch.clamp(1.0 - dist / _f32(sun_radius, dev), 0.0, 1.0)
    glare = k * k * (3.0 - 2.0 * k)
    sun_color = _f32([1.0, 0.85, 0.6, 0.0], dev)
    g = torch.where((day_factor > 0.0) & (dist < sun_radius), glare, 0.0)
    color = _fma(g[..., None] * sun_color, day_factor, color)

    # perlin cloud layer at 1500 units (pattern-bank perlin stands in for the
    # reference's own perlin_noise_2d realization)
    dy = ray_dir[..., 1]
    u, v, t_hit = cloud_uv(ray_dir, cam)
    bank = sky_pre["pattern_bank"]

    n = _fma(sample_pattern_jnp(bank, PATTERN_NAMES["perlin"], u, v), 2.0, -1.0)
    alpha_raw = (n + 1.0) * 0.5
    alpha = alpha_raw * torch.clamp(dy * 6.0, 0.0, 1.0)
    alpha = torch.where((dy > 0.0) & (t_hit > 0.0), alpha, 0.0)

    whiteness = 0.15 + (0.6 - 0.15) * day_factor
    base_colour = _fma(1.0 - color, whiteness, color)
    sun_lit = torch.clamp(_fma(ray_dir[..., 2], sun_dir[2],
                               _fma(ray_dir[..., 1], sun_dir[1],
                                    ray_dir[..., 0] * sun_dir[0])), min=0.0)
    sun_lit = sun_lit * sun_lit * sun_lit
    rim_day = _f32([1.0, 0.9, 0.8, 1.0], dev) * 0.4 * day_factor
    rim_night = _f32([0.6, 0.7, 1.0, 1.0], dev) * 0.08
    rim = torch.where(day_factor > 0.0, rim_day, rim_night) * sun_lit[..., None]
    cloud_colour = base_colour + rim
    return _fma(cloud_colour - color, alpha[..., None], color)


def sky_device_params(node, device) -> dict:
    """Precomputed vec4s -> dict of tensors on `device` for sky_miss."""
    if not node.precomputed:
        sky_setup(node, 12.0)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return {
        "sun": put(node.precomputed[0]),
        "haze": put(node.precomputed[1]),
        "day_horizon": put(node.precomputed[2]),
        "day_zenith": put(node.precomputed[3]),
        "night_horizon": put(node.precomputed[4]),
        "night_zenith": put(node.precomputed[5]),
        "pattern_bank": put(pattern_bank()),
    }


def fog_apply(color_rgb, world, cam_pos, fog_color, fog_end, fog_fade,
              fog_mode=0.0, fog_density=0.0):
    """Vectorized distance fog for pixels with geometry.

    Two falloffs, selected by the `fog_mode` scalar:
    - 0: the ShapeFX Fog render node's linear fade
      (shapefx.rs:1071-1083, t = clip((dist-end)/fade))
    - 1: the SceneVM exponential-squared fog the RenderSettings block
      drives (embedded/shader/3d_shader.wgsl:857-868,
      t = 1 - exp(-density * dist^2))
    Divergence note (the JAX package's): the WGSL fogs the linear color
    pre-gamma; this pipeline fogs the post-lighting sRGB color like the
    reference's Fog node — the blend end-points are identical, only mid-fog
    ramps differ by the transfer curve. Scalars are f32 values (numbers or
    0-d tensors); cam_pos and fog_color (3,) / (4,) f32."""
    dev = color_rgb.device

    def t32(x):
        return torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                               dtype=torch.float32, device=dev)

    d = world - t32(cam_pos)
    dist = torch.sqrt((d * d).sum(-1))
    t_lin = torch.clamp((dist - t32(fog_end)) / t32(fog_fade), 0.0, 1.0)
    mode, dens = t32(fog_mode), t32(fog_density)
    t_exp = 1.0 - torch.exp(-dens * dist * dist)
    t = mode * t_exp + (1.0 - mode) * t_lin
    return color_rgb * (1.0 - t[..., None]) + t32(fog_color)[:3] * t[..., None]

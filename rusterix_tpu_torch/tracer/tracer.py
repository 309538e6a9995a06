"""Progressive path tracer: the wavefront formulation of the JAX package's
`tracer/tracer.py` in plain torch, on the device the caller names.

reference: src/tracer/trace.rs (jittered camera rays, <= 8 bounces,
brute-force Möller-Trumbore over all batches, direct lighting x10,
specular/diffuse russian-roulette bounces, sky miss, running-average
AccumBuffer src/tracer/buffer.rs).

The whole frame is one wavefront: rays are (P,) component tensors, each
bounce intersects every ray against chunks of TRACER_CHUNK triangles with a
running closest hit, and shading and bounce decisions draw per-lane
uniforms from a threefry key (`rng.Key`, the bits of `jax.random`). Dead
lanes carry zero throughput; all bounces run, lane-masked. The JAX
package's `lax.scan`s over bounces and chunks are Python loops here, and
its winner selection is a row gather of one fused per-triangle table (the
one-hot matmul it takes for small packs is a TPU workaround). The tracer
was never a `pallas_call`: it is plain torch.

Parity with the JAX tracer on the CPU (`tests/test_torch_tracer.py`):
XLA's CPU build fuses products into FMAs; the port writes out (`_fma`)
those that decide a discrete outcome, the texel a hit reads, and takes
the square roots in f64 on the CPU (torch's vectorised f32 CPU square
root is not correctly rounded).
"""

from __future__ import annotations

import math
import uuid
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..models.batch import MaterialModifier, MaterialRole
from ..ops.scene_pack import SRC_PIXEL, SRC_TEXTURE, PackedScene
from ..ops.setup_pass import _fma
from ..ops.shade import (
    LT_AMBIENT,
    LT_AMBIENT_DAYLIGHT,
    LT_AREA,
    LT_DAYLIGHT,
    LT_POINT,
    LT_SPOT,
    _round_half_away,
    _sqrt_f32,
    _to_int,
    apply_repeat,
)
from ..utils.color import srgb_to_linear_fast
from .rng import PRNGKey, uniform_many


@dataclass
class AccumBuffer:
    """Running-average accumulation buffer (reference buffer.rs:5-127).

    The average lives on the device (`_dev`, (H, W, 4) f32 linear);
    `pixels` and `to_u8` read it back on demand. `accumulate` folds a
    sample in eagerly, as the JAX package does: two products and a sum,
    each rounded."""

    width: int
    height: int
    _dev: object = None
    frame: int = 0
    device: object = None

    def __post_init__(self):
        if self._dev is None:
            dev = resolve_device(self.device)
            self._dev = torch.zeros((self.height, self.width, 4), dtype=torch.float32,
                                    device=dev)
        self.device = self._dev.device

    def reset(self):
        self.frame = 0

    @property
    def pixels(self) -> np.ndarray:
        return self._dev.cpu().numpy()

    def _fold(self, sample):
        t = 1.0 / (self.frame + 1.0)
        self._dev = self._dev * (1.0 - t) + sample * t
        self.frame += 1

    def accumulate(self, linear_rgba):
        self._fold(torch.as_tensor(linear_rgba, dtype=torch.float32).to(self._dev.device))

    def accumulate_batch(self, linear_batch):
        """Fold a (n, H, W, 4) batch of samples in index order: the running
        average n accumulate() calls give, bit for bit (the sharded
        tracer's samples land here)."""
        batch = torch.as_tensor(linear_batch, dtype=torch.float32).to(self._dev.device)
        for i in range(batch.shape[0]):
            self._fold(batch[i])

    def to_u8(self) -> np.ndarray:
        """Accurate linear->sRGB (reference buffer.rs:69-76)."""
        x = np.clip(self.pixels, 0.0, 1.0)
        srgb = np.where(
            x <= 0.0031308, x * 12.92, 1.055 * np.power(np.maximum(x, 1e-8), 1 / 2.4) - 0.055
        )
        out = (np.clip(srgb, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        out[..., 3] = 255
        return out


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Z-order permutation of triangle centroids so spatially-near triangles
    share chunks (the same locality trick as the Pallas visibility kernel)."""
    if len(centroids) == 0:
        return np.zeros(0, np.int64)
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-20)
    q = np.clip(((centroids - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 32)) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << 16)) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << 8)) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << 4)) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << 2)) & np.uint64(0x1249249249249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )
    return np.argsort(code, kind="stable")


TRACER_CHUNK = 128


def _pack_tracer_scene(scene, assets, device=None):
    """Triangle SoA + per-tri material for the tracer.

    Triangles are Morton-ordered and grouped into TRACER_CHUNK-sized chunks
    with precomputed AABBs: the bounce loop skips a chunk's Moller-Trumbore
    math entirely when NO ray in the wavefront enters its box (the
    wavefront analogue of the reference's per-ray spatial pruning).
    `device` runs the pack's shader bakes."""
    packed = PackedScene.from_scene(scene, assets, device=device)
    d3 = packed.d3
    t = d3.pos.shape[0]
    # per-tri material from the owning batch (evaluate_hit, trace.rs:378-470)
    mat_mod = np.zeros(t, np.int32)
    mat_role = np.zeros(t, np.int32)
    mat_value = np.zeros(t, np.float32)
    i = 0
    for batch in scene.all_d3_batches():
        n = len(batch.indices)
        if batch.material is not None:
            mat_role[i : i + n] = int(batch.material.role)
            mat_mod[i : i + n] = int(batch.material.modifier)
            mat_value[i : i + n] = batch.material.value
        i += n

    # Morton-reorder every per-triangle array (dead slots sort to the end
    # because their pos is the origin; their valid flag still guards them)
    centroids = d3.pos[:, :, :3].mean(axis=1)
    live = d3.valid > 0.5
    # keep dead padding at the end so chunk AABBs of padding are empty
    order_live = _morton_order(centroids[live])
    order = np.concatenate([np.nonzero(live)[0][order_live], np.nonzero(~live)[0]])
    for name in vars(d3):
        arr = getattr(d3, name)
        if isinstance(arr, np.ndarray) and arr.shape[:1] == (t,):
            setattr(d3, name, arr[order])
    mat_role, mat_mod, mat_value = mat_role[order], mat_mod[order], mat_value[order]

    # chunk AABBs (inverted boxes for all-dead chunks -> slab test misses)
    nchunks = (t + TRACER_CHUNK - 1) // TRACER_CHUNK
    box_min = np.full((nchunks, 3), 1e30, np.float32)
    box_max = np.full((nchunks, 3), -1e30, np.float32)
    for ci in range(nchunks):
        sl = slice(ci * TRACER_CHUNK, min((ci + 1) * TRACER_CHUNK, t))
        v = d3.valid[sl] > 0.5
        if v.any():
            pts = d3.pos[sl][v][:, :, :3].reshape(-1, 3)
            box_min[ci] = pts.min(axis=0)
            box_max[ci] = pts.max(axis=0)

    return packed, {
        "role": mat_role,
        "modifier": mat_mod,
        "value": mat_value,
    }, {"box_min": box_min, "box_max": box_max}


def _to_device(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


class Tracer:
    """reference src/tracer/trace.rs:31+, on the device the caller names
    (None is CUDA)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.hour = 12.0
        self.sky_horizon = np.array([0.8, 0.7, 0.6], np.float32)
        self.sky_zenith = np.array([0.1, 0.4, 0.9], np.float32)
        self.bounces = 8
        #: wavefront chunk-AABB skipping (Morton-ordered 2-level pruning),
        #: default off as in the JAX package: a chunk no ray enters is
        #: skipped (one host sync per chunk and bounce); the result is the
        #: same either way
        self.use_aabb_skip = False
        self._cache_key = None
        #: device -> the packed scene placed there (trace_sharded's other
        #: devices), once per scene
        self._placed = {}
        self._cache = None
        self._n_live_chunks = None
        self._has_tex = True
        self.sample_mode = 0
        self.background = None
        #: ShapeFX render graph (trace.rs:41-48,120-143 set_render_graph):
        #: when a Sky node sits on the graph's MISS terminal, missed rays
        #: shade through the same render_miss_d3 sky the rasterizer uses
        #: instead of the built-in debug gradient. (Reference divergence,
        #: documented: with NO miss nodes the reference contributes nothing
        #: — black sky; we keep the debug gradient as the default so the
        #: standalone tracer example stays legible.)
        self.render_graph = None

    def set_render_graph(self, graph) -> "Tracer":
        """trace.rs set_render_graph builder."""
        self.render_graph = graph
        return self

    def set_sample_mode(self, mode: int) -> "Tracer":
        """trace.rs sample_mode builder."""
        self.sample_mode = int(mode)
        return self

    def set_background(self, shader) -> "Tracer":
        """trace.rs background builder (miss shading falls back to the
        procedural sky when None)."""
        self.background = shader
        return self

    @staticmethod
    def reflect(i, n):
        """i - 2(i.n)n (trace.rs:478-480)."""
        i = np.asarray(i, np.float32)
        n = np.asarray(n, np.float32)
        return i - 2.0 * float(i @ n) * n

    def _ensure_cache(self, scene, assets) -> dict:
        """Device-side packed scene, keyed like the rasterizer's scene cache:
        uuid tokens of the scene and the assets (not id(), which CPython
        reuses after GC), the scene revision and the device."""
        if not hasattr(scene, "_cache_uid"):
            scene._cache_uid = uuid.uuid4().hex
        if not hasattr(assets, "_cache_uid"):
            assets._cache_uid = uuid.uuid4().hex
        key = (scene._cache_uid, scene.revision, assets._cache_uid, str(self.device))
        if self._cache_key != key:
            packed, mats, boxes = _pack_tracer_scene(scene, assets, self.device)
            atlas_np = packed.atlas_index.atlas
            # live tris are a Morton-ordered PREFIX (dead padding sorts to
            # the end in _pack_tracer_scene), so the intersect loop stops
            # at the last live chunk
            n_live = int((packed.d3.valid > 0.5).sum())
            t_slots = packed.d3.valid.shape[0]
            chunk = min(TRACER_CHUNK, t_slots)
            self._n_live_chunks = max(1, -(-n_live // chunk))
            # a pack with no SRC_TEXTURE triangle skips the atlas fetch
            self._has_tex = bool((packed.d3.kind == SRC_TEXTURE).any())
            dev = self.device
            self._cache = {
                "d3": _to_device(vars(packed.d3), dev),
                "mats": _to_device(mats, dev),
                "boxes": _to_device(boxes, dev),
                "lights": packed.lights,
                "light_count": packed.light_count,
                "atlas": {
                    "flat": torch.from_numpy(
                        np.ascontiguousarray(atlas_np.data.reshape(-1, 4))).to(dev),
                    "w": int(atlas_np.data.shape[1]),
                    **_to_device({"rects": atlas_np.rects, "tile_first": atlas_np.tile_first,
                                  "tile_count": atlas_np.tile_count}, dev),
                },
            }
            self._cache_key = key
            self._placed = {}
        return self._cache

    def _cache_on(self, cache, device) -> dict:
        """The packed scene on `device`: `cache` on the tracer's device,
        else its copy there, placed once per scene and device."""
        if device == self.device:
            return cache
        hit = self._placed.get(device)
        if hit is None:
            hit = {k: ({f: t.to(device) if torch.is_tensor(t) else t for f, t in v.items()}
                       if k in ("d3", "mats", "boxes", "atlas") else v)
                   for k, v in cache.items()}
            self._placed[device] = hit
        return hit

    def _lights_dev(self, cache) -> dict:
        """The pack's light rows with a flicker factor of 1, and "rows": the
        valid rows' indices. They stay on the host: every light parameter
        is a scalar operand of the per-ray math."""
        lights = dict(cache["lights"])
        lights["flicker_factor"] = np.ones_like(lights["valid"])
        lights["rows"] = [int(i) for i in np.nonzero(lights["valid"] > 0.5)[0]]
        return lights

    def _sky_pre(self, device=None):
        """Sky node on the miss terminal -> render_miss_d3 device params."""
        if self.render_graph is None:
            return None
        from ..shapefx import ShapeFXRole
        from ..shapefx.render import sky_device_params

        for ni in self.render_graph.collect_nodes_from(0, 1):
            node = self.render_graph.nodes[ni]
            node.render_setup(self.hour)
            if node.role == ShapeFXRole.Sky:
                return sky_device_params(node, self.device if device is None else device)
        return None

    def _frame(self, cache, camera, scene, width: int, height: int, seed: int, device,
               lights, sky_pre) -> torch.Tensor:
        """One sample, (H, W, 4) f32 linear, on `device`."""
        cache = self._cache_on(cache, device)
        pos, forward, right, up = self._camera_basis(camera)
        return _trace_frame(
            cache["d3"], cache["mats"], cache["boxes"], lights, cache["atlas"],
            pos, forward, right, up, np.float32(np.tan(np.radians(camera.fov) * 0.5)),
            self.sky_horizon, self.sky_zenith,
            PRNGKey(seed), int(scene.animation_frame), width, height, self.bounces,
            self.use_aabb_skip, n_live_chunks=self._n_live_chunks, sky_pre=sky_pre,
            has_tex=self._has_tex,
        )

    def trace_sharded(self, camera, scene, buffer: AccumBuffer,
                      tile_size: int, assets, mesh) -> None:
        """`len(mesh)` progressive samples in one call, one full-frame
        sample per device of the mesh (a tuple of torch devices:
        parallel.card_mesh, a sample on each card, or parallel.make_mesh);
        each device other than the tracer's holds its own copy of the
        packed scene, placed once per scene (`_cache_on`); the samples axis is embarrassingly parallel (the
        reference fans its sample loop over rayon tiles the same way,
        src/tracer/trace.rs:105-190).

        Sample i takes the key trace() would use at frame + i
        ((frame + i) * 7919 + 13); the samples are gathered on the
        buffer's device and folded by accumulate_batch in index order, so
        a buffer after trace_sharded equals the same buffer after
        len(mesh) trace() calls, bit for bit."""
        from ..parallel import check_mesh

        mesh = check_mesh(mesh)
        c = self._ensure_cache(scene, assets)
        frames = []
        for i, dev in enumerate(mesh):
            lin = self._frame(c, camera, scene, buffer.width, buffer.height,
                              ((buffer.frame + i) * 7919 + 13) & 0xFFFFFFFF, dev,
                              self._lights_dev(c), self._sky_pre(dev))
            frames.append(lin.to(buffer._dev.device))
        buffer.accumulate_batch(torch.stack(frames))

    def trace(self, camera, scene, buffer: AccumBuffer, tile_size: int, assets) -> None:
        """One progressive sample per pixel; accumulates into `buffer`."""
        c = self._ensure_cache(scene, assets)
        linear = self._frame(c, camera, scene, buffer.width, buffer.height,
                             buffer.frame * 7919 + 13, self.device, self._lights_dev(c),
                             self._sky_pre())
        buffer.accumulate(linear)

    @staticmethod
    def _camera_basis(camera):
        forward, right, up = camera.basis_vectors()
        return camera.position(), forward, right, up


def _sum3(a, x, b, y, c, z):
    """a*x + b*y + c*z as XLA's CPU build fuses it: fma(c, z, fma(a, x, b*y))."""
    return _fma(c, z, _fma(a, x, b * y))


def _light_sum_soa(lights, wx, wy, wz, nx, ny, nz):
    """SoA re-expression of ops.shade.light_radiance summed over lights.

    Identical formulas (CompiledLight::radiance_at, light.rs:491-653),
    component-wise over (P,) ray tensors with a Python loop over the padded
    light rows. `lights` is the pack's numpy rows (Tracer._lights_dev);
    "rows" lists the valid ones, each row's type picks its branch in Python,
    and its parameters are f32 scalars, combined on the host in f32 where
    the JAX package combines two of them. A row the pack marks invalid adds
    nothing and is skipped (its term is an exact zero in the JAX package's
    sum)."""
    acc_r = torch.zeros_like(wx)
    acc_g = torch.zeros_like(wx)
    acc_b = torch.zeros_like(wx)
    for i in lights["rows"]:
        def f(key, *ix):
            return np.float32(lights[key][(i,) + ix])

        lt = int(lights["type"][i])
        from_linedef = bool(lights["from_linedef"][i] > 0.5)
        start, end, inten_raw = f("start"), f("end"), f("intensity")
        inten = float(inten_raw * f("flicker_factor"))
        tpx = wx - float(f("position", 0))
        tpy = wy - float(f("position", 1))
        tpz = wz - float(f("position", 2))
        dist = _sqrt_f32(_sum3(tpx, tpx, tpy, tpy, tpz, tpz))
        in_range = dist < float(end)
        # _smoothstep(end, start, dist)
        st = torch.clamp((dist - float(end)) / float(start - end), 0.0, 1.0)
        smooth_att = torch.where(dist <= float(start), 1.0, st * st * _fma(-2.0, st, 3.0))
        inv_dist = 1.0 / torch.clamp(dist, min=1e-20)
        dpx, dpy, dpz = tpx * inv_dist, tpy * inv_dist, tpz * inv_dist
        ambient = lt in (LT_AMBIENT, LT_AMBIENT_DAYLIGHT)
        if lt == LT_POINT:
            scale = inten * smooth_att
        elif ambient:
            scale = torch.full_like(wx, inten)
        elif lt == LT_SPOT:
            lin_att = torch.where(
                dist <= float(start), 1.0,
                1.0 - (dist - float(start)) / float(max(end - start, np.float32(1e-20))))
            cosang = torch.clamp(_sum3(f("direction", 0), dpx, f("direction", 1), dpy,
                                       f("direction", 2), dpz), -1.0, 1.0)
            spot_ok = torch.arccos(cosang.double()).float() <= float(f("cone_angle"))
            scale = torch.where(spot_ok, inten * lin_att, 0.0)
        else:
            angle_att = torch.clamp(_sum3(f("normal", 0), dpx, f("normal", 1), dpy,
                                          f("normal", 2), dpz), min=0.0)
            if lt == LT_AREA:
                area = float(f("width") * f("height"))
                if from_linedef:
                    scale = smooth_att * area * float(inten_raw)
                else:
                    scale = angle_att * smooth_att * area * float(inten_raw)
                scale = torch.where(dist < 0.1, 1.0, scale)
            else:
                scale = angle_att * smooth_att * float(inten_raw)
        valid = torch.ones_like(in_range) if ambient else in_range
        if lt == LT_SPOT:
            valid = valid & spot_ok

        # Lambert for point/spot/area (light.rs:504-533): ldir = -to_point/|.|
        if ambient or lt == LT_DAYLIGHT:
            s = scale
        else:
            s = scale * torch.clamp(-_sum3(nx, dpx, ny, dpy, nz, dpz), min=0.0)
        s = torch.where(valid, s, 0.0)
        acc_r = _fma(f("color", 0), s, acc_r)
        acc_g = _fma(f("color", 1), s, acc_g)
        acc_b = _fma(f("color", 2), s, acc_b)
    return acc_r, acc_g, acc_b


def intersect_all(tri_rows, boxes, chunk: int, ox, oy, oz, dx, dy, dz,
                  use_aabb_skip: bool = False):
    """Möller-Trumbore of the (P,) rays over the triangles, chunk by chunk
    -> (t, tri): the closest hit, inf and -1 on a miss; ties keep the
    lower slot. tri_rows holds each chunk's (1, C) rows (A, e1, e2 by
    component, the valid mask); the chunks are TRACER_CHUNK slots or
    fewer. With use_aabb_skip, a chunk whose box (boxes["box_min"] /
    ["box_max"]) no ray enters closer than its best t is skipped."""
    p, dev = ox.shape[0], ox.device
    best_t = torch.full((p,), float("inf"), device=dev)
    best_i = torch.full((p,), -1, dtype=torch.int64, device=dev)
    if use_aabb_skip:
        def inv(d):
            return 1.0 / torch.where(d.abs() < 1e-20, 1e-20, d)

        inv_dx, inv_dy, inv_dz = inv(dx), inv(dy), inv(dz)
    for ci in range(len(tri_rows)):
        if use_aabb_skip:
            bmin, bmax = boxes["box_min"][ci], boxes["box_max"][ci]
            t0x, t1x = (bmin[0] - ox) * inv_dx, (bmax[0] - ox) * inv_dx
            t0y, t1y = (bmin[1] - oy) * inv_dy, (bmax[1] - oy) * inv_dy
            t0z, t1z = (bmin[2] - oz) * inv_dz, (bmax[2] - oz) * inv_dz
            tnear = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                                torch.minimum(t0y, t1y)),
                                  torch.minimum(t0z, t1z))
            tfar = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                               torch.maximum(t0y, t1y)),
                                 torch.maximum(t0z, t1z))
            enters = (tfar >= torch.clamp(tnear, min=0.0)) & (tnear < best_t)
            if not bool(enters.any()):
                continue
        ax_, ay_, az_, e1x, e1y, e1z, e2x, e2y, e2z, valid = tri_rows[ci]
        dxc, dyc, dzc = dx[:, None], dy[:, None], dz[:, None]
        # h = d x e2
        hx = _fma(dyc, e2z, -(dzc * e2y))
        hy = _fma(dzc, e2x, -(dxc * e2z))
        hz = _fma(dxc, e2y, -(dyc * e2x))
        det = _sum3(e1x, hx, e1y, hy, e1z, hz)
        ok = (det.abs() >= 1e-6) & valid
        f = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        svx = ox[:, None] - ax_
        svy = oy[:, None] - ay_
        svz = oz[:, None] - az_
        uu = f * _sum3(svx, hx, svy, hy, svz, hz)
        ok &= (uu >= 0.0) & (uu <= 1.0)
        # q = sv x e1
        qx = _fma(svy, e1z, -(svz * e1y))
        qy = _fma(svz, e1x, -(svx * e1z))
        qz = _fma(svx, e1y, -(svy * e1x))
        vv = f * _sum3(dxc, qx, dyc, qy, dzc, qz)
        ok &= (vv >= 0.0) & (uu + vv <= 1.0)
        # XLA fuses this dot from its second term (checked against jitted JAX)
        tt = f * _sum3(e2y, qy, e2x, qx, e2z, qz)
        ok &= tt > 1e-4
        tt = torch.where(ok, tt, float("inf"))
        tmin, local = torch.min(tt, dim=-1)
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, ci * chunk + local, best_i)
    return best_t, best_i


def _trace_frame(
    d3,
    mats,
    boxes,
    lights,
    atlas,
    cam_pos,
    forward,
    right,
    up,
    half_height_tan: float,
    sky_horizon,
    sky_zenith,
    rng_key,
    anim_frame: int,
    width: int,
    height: int,
    bounces: int,
    use_aabb_skip: bool = False,
    n_live_chunks: int = None,
    sky_pre=None,
    has_tex: bool = True,
):
    """One progressive sample, (H, W, 4) f32 linear, on the device of the
    pack's tensors; rng_key is an rng.Key (the JAX tracer's PRNGKey). The
    camera, the sky colours and the lights are host values (f32 scalars
    of the per-ray math).

    Every per-ray quantity is a separate (P,) component tensor, as in the
    JAX package's SoA formulation."""
    dev = d3["pos"].device
    p = width * height
    cam_pos, forward, right, up, sky_horizon, sky_zenith = (
        np.asarray(a, np.float32) for a in (cam_pos, forward, right, up, sky_horizon,
                                            sky_zenith))
    half_height_tan = float(np.float32(half_height_tan))
    aspect = width / height

    keys = rng_key.split(4 + bounces * 3)
    # every draw of the sample in one pass of the cipher: the jitter, then
    # per bounce the specular choice, the two hemisphere numbers and the
    # roulette (keys as the JAX tracer derives them)
    draws = [(keys[0], (p, 2))]
    for kidx in range(bounces):
        k1 = rng_key.fold_in(kidx * 3 + 1)
        draws += [(k1, (p,)), (rng_key.fold_in(kidx * 3 + 2), (p,)),
                  (rng_key.fold_in(kidx * 3 + 3), (p,)), (k1.fold_in(99), (p,))]
    rand = uniform_many(draws, dev)
    jitter = rand[0]

    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    # screen uv with y flip + jitter (trace.rs:175-183, d3orbit create_ray),
    # rounded as XLA's CPU build computes the JAX expressions (checked against
    # jitted JAX): x / width as x * f32(1 / width), folded into u * 2.0, and
    # the products that feed a sum fused
    inv_w = np.float32(1.0 / width)
    inv_h = float(np.float32(1.0 / height))
    cx = (_fma(xs.reshape(-1) + jitter[:, 0], float(np.float32(2.0 * inv_w)), -1.0)
          * half_height_tan * float(np.float32(aspect)))
    v = _fma(-(ys.reshape(-1) + jitter[:, 1]), inv_h, 1.0)
    cy = -_fma(v, 2.0, -1.0) * half_height_tan
    dx = _fma(-float(up[0]), cy, _fma(float(right[0]), cx, float(forward[0])))
    dy = _fma(-float(up[1]), cy, _fma(float(right[1]), cx, float(forward[1])))
    dz = _fma(-float(up[2]), cy, _fma(float(right[2]), cx, float(forward[2])))
    inv_len = 1.0 / _sqrt_f32(_sum3(dx, dx, dy, dy, dz, dz))
    dx, dy, dz = dx * inv_len, dy * inv_len, dz * inv_len
    ox = torch.full((p,), float(cam_pos[0]), device=dev)
    oy = torch.full((p,), float(cam_pos[1]), device=dev)
    oz = torch.full((p,), float(cam_pos[2]), device=dev)

    pos = d3["pos"]
    t_ax, t_ay, t_az = pos[:, 0, 0], pos[:, 0, 1], pos[:, 0, 2]
    t_e1x, t_e1y, t_e1z = pos[:, 1, 0] - t_ax, pos[:, 1, 1] - t_ay, pos[:, 1, 2] - t_az
    t_e2x, t_e2y, t_e2z = pos[:, 2, 0] - t_ax, pos[:, 2, 1] - t_ay, pos[:, 2, 2] - t_az
    tri_valid = d3["valid"] > 0.5

    # fused per-tri attribute table, built once per frame: everything the
    # bounce shading needs rides one winner row gather. Columns:
    #   0-2 vertex A | 3-5 e1 | 6-8 e2 | 9-14 uv (ua ub uc va vb vc) |
    #   15-23 nrm a/b/c xyz | 24 has_normals | 25 kind | 26-29 rgba |
    #   30 repeat | 31 mat role | 32 mat modifier | 33 mat value |
    #   34-37 atlas rect (x y w h) for this animation frame
    slot_t = torch.clamp(d3["tex_slot"], min=0).long()
    count = torch.clamp(atlas["tile_count"][slot_t], min=1)
    tex_id_t = atlas["tile_first"][slot_t] + torch.remainder(
        torch.as_tensor(anim_frame, dtype=count.dtype, device=dev), count)
    rect_t = atlas["rects"][tex_id_t.long()].float()
    uv, nrm, rgba = d3["uv"], d3["nrm"], d3["rgba"]
    fused_tab = torch.cat([
        torch.stack([
            t_ax, t_ay, t_az, t_e1x, t_e1y, t_e1z, t_e2x, t_e2y, t_e2z,
            uv[:, 0, 0], uv[:, 1, 0], uv[:, 2, 0], uv[:, 0, 1], uv[:, 1, 1], uv[:, 2, 1],
            nrm[:, 0, 0], nrm[:, 1, 0], nrm[:, 2, 0], nrm[:, 0, 1], nrm[:, 1, 1], nrm[:, 2, 1],
            nrm[:, 0, 2], nrm[:, 1, 2], nrm[:, 2, 2],
            d3["has_normals"].float(), d3["kind"].float(),
            rgba[:, 0], rgba[:, 1], rgba[:, 2], rgba[:, 3],
            d3["repeat"].float(), mats["role"].float(), mats["modifier"].float(),
            mats["value"].float(),
        ], dim=1),
        rect_t,
    ], dim=1)  # (T, 38)

    tcount = t_ax.shape[0]
    chunk = min(TRACER_CHUNK, tcount)
    nchunks = (tcount + chunk - 1) // chunk
    if n_live_chunks is not None:
        # live tris are a prefix (pack invariant): trailing all-dead chunks
        # can never win
        nchunks = min(nchunks, max(1, n_live_chunks))
    tri_rows = [
        tuple(x[ci * chunk:(ci + 1) * chunk][None, :]
              for x in (t_ax, t_ay, t_az, t_e1x, t_e1y, t_e1z, t_e2x, t_e2y, t_e2z,
                        tri_valid))
        for ci in range(nchunks)
    ]

    ret_r = torch.zeros(p, device=dev)
    ret_g = torch.zeros(p, device=dev)
    ret_b = torch.zeros(p, device=dev)
    tp_r = torch.ones(p, device=dev)
    tp_g = torch.ones(p, device=dev)
    tp_b = torch.ones(p, device=dev)
    active = torch.ones(p, dtype=torch.bool, device=dev)
    for kidx in range(bounces):
        r_spec, r1, r2, rr = rand[1 + 4 * kidx: 5 + 4 * kidx]
        t, tri = intersect_all(tri_rows, boxes, chunk, ox, oy, oz, dx, dy, dz, use_aabb_skip)
        hit = (tri >= 0) & active
        g = fused_tab[torch.clamp(tri, min=0)]  # (P, 38): the winner rows

        def col(i):
            return g[:, i]

        # winner u/v: one single-triangle Möller-Trumbore per ray on the
        # selected components (misses read row 0, masked by `hit`)
        w_ax, w_ay, w_az = col(0), col(1), col(2)
        g_e1x, g_e1y, g_e1z = col(3), col(4), col(5)
        g_e2x, g_e2y, g_e2z = col(6), col(7), col(8)
        whx = _fma(dy, g_e2z, -(dz * g_e2y))
        why = _fma(dz, g_e2x, -(dx * g_e2z))
        whz = _fma(dx, g_e2y, -(dy * g_e2x))
        wdet = _sum3(g_e1x, whx, g_e1y, why, g_e1z, whz)
        wf = torch.where(wdet.abs() >= 1e-6, 1.0 / torch.where(wdet == 0.0, 1.0, wdet), 0.0)
        wsx, wsy, wsz = ox - w_ax, oy - w_ay, oz - w_az
        uu = wf * _sum3(wsx, whx, wsy, why, wsz, whz)
        wqx = _fma(wsy, g_e1z, -(wsz * g_e1y))
        wqy = _fma(wsz, g_e1x, -(wsx * g_e1z))
        wqz = _fma(wsx, g_e1y, -(wsy * g_e1x))
        vv = wf * _sum3(dx, wqx, dy, wqy, dz, wqz)
        w0 = 1.0 - uu - vv

        uv_u = _sum3(col(9), w0, col(10), uu, col(11), vv)
        uv_v = _sum3(col(12), w0, col(13), uu, col(14), vv)
        has_n = col(24) > 0.5
        nx = torch.where(has_n, _sum3(col(15), w0, col(16), uu, col(17), vv),
                         _fma(g_e1y, g_e2z, -(g_e1z * g_e2y)))
        ny = torch.where(has_n, _sum3(col(18), w0, col(19), uu, col(20), vv),
                         _fma(g_e1z, g_e2x, -(g_e1x * g_e2z)))
        nz = torch.where(has_n, _sum3(col(21), w0, col(22), uu, col(23), vv),
                         _fma(g_e1x, g_e2y, -(g_e1y * g_e2x)))
        inv_nl = 1.0 / torch.clamp(_sqrt_f32(_sum3(nx, nx, ny, ny, nz, nz)), min=1e-20)
        nx, ny, nz = nx * inv_nl, ny * inv_nl, nz * inv_nl
        # face the incoming ray (batch3d.rs:925-928)
        flip = torch.where(_sum3(nx, dx, ny, dy, nz, dz) > 0, -1.0, 1.0)
        nx, ny, nz = nx * flip, ny * flip, nz * flip

        # texel resolve with the prefolded rect (resolve_texel semantics,
        # nearest mode): the atlas fetch is skipped when the pack has no
        # SRC_TEXTURE triangle
        kind_c = col(25).to(torch.int32)
        rgba_c = g[:, 26:30]
        if has_tex:
            uu_r, vv_r = apply_repeat(uv_u, uv_v, col(30).to(torch.int32))
            rw_f = col(36)
            rh_f = col(37)
            tx_i = torch.minimum(torch.clamp(_to_int(_round_half_away(uu_r * (rw_f - 1.0))),
                                             min=0), _to_int(rw_f) - 1)
            ty_i = torch.minimum(torch.clamp(_to_int(_round_half_away(vv_r * (rh_f - 1.0))),
                                             min=0), _to_int(rh_f) - 1)
            flat_ix = (_to_int(col(35)) + ty_i) * atlas["w"] + _to_int(col(34)) + tx_i
            flat = atlas["flat"]
            tx4 = flat[torch.clamp(flat_ix, 0, flat.shape[0] - 1).long()].float() * (1.0 / 255.0)
            texel = torch.where((kind_c == SRC_TEXTURE)[:, None], tx4, 0.0)
            texel = torch.where((kind_c == SRC_PIXEL)[:, None], rgba_c, texel)
            is_other = (kind_c != SRC_TEXTURE) & (kind_c != SRC_PIXEL)
        else:
            texel = torch.where((kind_c == SRC_PIXEL)[:, None], rgba_c, 0.0)
            is_other = kind_c != SRC_PIXEL
        black = torch.zeros_like(rgba_c)
        black[:, 3] = 1.0
        texel = torch.where(is_other[:, None], black, texel)
        tex_r, tex_g, tex_b = texel[:, 0], texel[:, 1], texel[:, 2]
        alb_r = srgb_to_linear_fast(tex_r)
        alb_g = srgb_to_linear_fast(tex_g)
        alb_b = srgb_to_linear_fast(tex_b)

        # material roles + per-hit modifier (trace.rs evaluate_hit:438-465:
        # modifier.modify(&texel, &material.value) on the SAMPLED texel)
        role = col(31).to(torch.int32)
        modifier = col(32).to(torch.int32)
        raw_value = col(33)
        lum = _sum3(0.2126, tex_r, 0.7152, tex_g, 0.0722, tex_b)
        mx = torch.maximum(torch.maximum(tex_r, tex_g), tex_b)
        mn = torch.minimum(torch.minimum(tex_r, tex_g), tex_b)
        sat = torch.where(mx > 0.0, (mx - mn) / torch.clamp(mx, min=1e-20), 0.0)
        value = torch.where(
            modifier == int(MaterialModifier.Luminance), lum * raw_value,
            torch.where(
                modifier == int(MaterialModifier.InvLuminance), (1.0 - lum) * raw_value,
                torch.where(
                    modifier == int(MaterialModifier.Saturation), sat * raw_value,
                    torch.where(modifier == int(MaterialModifier.InvSaturation),
                                (1.0 - sat) * raw_value, raw_value))))
        spec_w = torch.where(
            role == int(MaterialRole.Matte), 1.0 - value,
            torch.where((role == int(MaterialRole.Glossy))
                        | (role == int(MaterialRole.Metallic)), value, 0.0))
        em_on = role == int(MaterialRole.Emissive)
        em_scale = torch.where(em_on, raw_value * 10.0, 0.0)
        em_r, em_g, em_b = alb_r * em_scale, alb_g * em_scale, alb_b * em_scale

        wx = _fma(dx, t, ox)
        wy = _fma(dy, t, oy)
        wz = _fma(dz, t, oz)
        is_emissive = (em_r != 0.0) | (em_g != 0.0) | (em_b != 0.0)
        add_em = (hit & is_emissive).float()
        ret_r = _fma(add_em * em_r, tp_r, ret_r)
        ret_g = _fma(add_em * em_g, tp_g, ret_g)
        ret_b = _fma(add_em * em_b, tp_b, ret_b)

        # direct lighting x10 (trace.rs:281-291)
        dir_r, dir_g, dir_b = _light_sum_soa(lights, wx, wy, wz, nx, ny, nz)
        add_d = (hit & ~is_emissive).float() * float(np.float32(10.0 / math.pi))
        ret_r = _fma(add_d * dir_r * tp_r, alb_r, ret_r)
        ret_g = _fma(add_d * dir_g * tp_g, alb_g, ret_g)
        ret_b = _fma(add_d * dir_b * tp_b, alb_b, ret_b)

        # bounce: specular vs cosine diffuse (trace.rs:293-307)
        p_spec = torch.clamp(spec_w, 0.0, 1.0)
        choose_spec = r_spec < p_spec
        pdf = torch.where(choose_spec, p_spec, 1.0 - p_spec)
        d_dot_n = _sum3(dx, nx, dy, ny, dz, nz)
        refl_x = _fma(-2.0 * d_dot_n, nx, dx)
        refl_y = _fma(-2.0 * d_dot_n, ny, dy)
        refl_z = _fma(-2.0 * d_dot_n, nz, dz)

        # cosine hemisphere sample around n
        phi = float(np.float32(2.0 * math.pi)) * r1
        sq = _sqrt_f32(r2)
        # tangent = n x pick, pick = |n.x| < 0.9 ? (1,0,0) : (0,1,0)
        pick_x = torch.where(nx.abs() < 0.9, 1.0, 0.0)
        pick_y = 1.0 - pick_x
        tx = -nz * pick_y
        ty = nz * pick_x
        tz = _fma(nx, pick_y, -(ny * pick_x))
        inv_tl = 1.0 / torch.clamp(_sqrt_f32(_sum3(tx, tx, ty, ty, tz, tz)), min=1e-20)
        tx, ty, tz = tx * inv_tl, ty * inv_tl, tz * inv_tl
        # bitan = n x tangent
        bx = _fma(ny, tz, -(nz * ty))
        by = _fma(nz, tx, -(nx * tz))
        bz = _fma(nx, ty, -(ny * tx))
        ca, sa = torch.cos(phi) * sq, torch.sin(phi) * sq
        cz_ = _sqrt_f32(torch.clamp(1.0 - r2, min=0.0))
        cos_x = _sum3(tx, ca, bx, sa, nx, cz_)
        cos_y = _sum3(ty, ca, by, sa, ny, cz_)
        cos_z = _sum3(tz, ca, bz, sa, nz, cz_)

        spec_f = choose_spec.float()
        new_dx = _fma(spec_f, refl_x, (1.0 - spec_f) * cos_x)
        new_dy = _fma(spec_f, refl_y, (1.0 - spec_f) * cos_y)
        new_dz = _fma(spec_f, refl_z, (1.0 - spec_f) * cos_z)
        tp_spec = spec_w / torch.clamp(pdf, min=1e-6)
        tp_diff = (1.0 - p_spec) / torch.clamp(pdf * float(np.float32(math.pi)), min=1e-6)
        new_tp_r = torch.where(choose_spec, tp_r * tp_spec, tp_r * alb_r * tp_diff)
        new_tp_g = torch.where(choose_spec, tp_g * tp_spec, tp_g * alb_g * tp_diff)
        new_tp_b = torch.where(choose_spec, tp_b * tp_spec, tp_b * alb_b * tp_diff)

        miss_f = ((tri < 0) & active).float()
        if sky_pre is not None:
            # ShapeFX Sky node on the miss terminal: the same render_miss_d3
            # sky the rasterizer draws (trace.rs:332-346: the colour in sRGB,
            # converted to linear before accumulating)
            from ..shapefx.render import sky_miss

            sky = sky_miss(sky_pre, torch.stack([dx, dy, dz], dim=-1), cam_pos)
            sky_lin = [srgb_to_linear_fast(torch.clamp(sky[:, c], 0.0, 1.0)) for c in range(3)]
        else:
            # miss -> sky gradient (debug sky, rasterizer.rs:1824-1842
            # analogue). Reference divergence (documented on Tracer): with
            # no miss nodes the reference adds NOTHING (black).
            sky_t = (torch.clamp(dy, -1.0, 1.0) + 1.0) * 0.5
            sky_lin = [srgb_to_linear_fast(_fma(float(sky_zenith[c] - sky_horizon[c]), sky_t,
                                                float(sky_horizon[c]))) for c in range(3)]

        ret_r = _fma(miss_f * sky_lin[0], tp_r, ret_r)
        ret_g = _fma(miss_f * sky_lin[1], tp_g, ret_g)
        ret_b = _fma(miss_f * sky_lin[2], tp_b, ret_b)

        # russian roulette (trace.rs:310-318)
        pmax = torch.clamp(torch.maximum(torch.maximum(new_tp_r, new_tp_g), new_tp_b),
                           0.001, 1.0)
        survive = rr <= pmax
        inv_pmax = 1.0 / pmax
        new_tp_r = new_tp_r * inv_pmax
        new_tp_g = new_tp_g * inv_pmax
        new_tp_b = new_tp_b * inv_pmax

        # carry updates select with where(), not arithmetic masking: missed
        # rays have t=inf, and 0*inf would NaN the carried origin
        new_active = hit & ~is_emissive & survive
        ox = torch.where(new_active, _fma(nx, 0.01, wx), ox)
        oy = torch.where(new_active, _fma(ny, 0.01, wy), oy)
        oz = torch.where(new_active, _fma(nz, 0.01, wz), oz)
        dx = torch.where(new_active, new_dx, dx)
        dy = torch.where(new_active, new_dy, dy)
        dz = torch.where(new_active, new_dz, dz)
        tp_r = torch.where(new_active, new_tp_r, tp_r)
        tp_g = torch.where(new_active, new_tp_g, tp_g)
        tp_b = torch.where(new_active, new_tp_b, tp_b)
        active = new_active

    rgba = torch.stack([ret_r, ret_g, ret_b, torch.ones_like(ret_r)], dim=-1)
    return rgba.reshape(height, width, 4)

// Opaque-frame megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mega_kernel` in rusterix_tpu/ops/megakernel.py
// (launched by `mega_render` there): for one 64x128 screen tile it runs, in
// one program, (1) the front-to-back hierarchical visibility scan over
// Morton-sorted super-chunks of 128 candidate slots and chunks of 4, with
// max 1/z and a strict `>`, (2) plane interpolation of 1/w, u, v and the
// normal, (3) the atlas texel fetch, nearest or bilinear, with the repeat
// modes, (4) the lighting chain (hemisphere ambient, sun with the fast
// Blinn-Phong BRDF or, in the `brdf_ggx` variant, Cook-Torrance GGX,
// occlusion boxes, batch ambient and the five light types; in the `ao_img`
// variant the two ambient terms scaled by the frame's ambient-occlusion
// factor at the pixel; in the shadow variant each casting light's radiance
// and the sun's scaled by a depth-compare lookup in its shadow map and, in
// its transmittance form, by the transparent layers between the light and
// the receiver), the display encode (the fast sRGB polynomial or, in the
// `tonemap` variant, the SceneVM transform: Reinhard, then gamma 1/2.2 as
// expf(logf(t) / 2.2)), (5) linear or exp^2 fog, and (6) the composite over
// the background and the RGBA8 pack. Outputs: packed RGBA8 per pixel and the effective z (1.0
// where the opaque pass did not write). `stage_cut` 1 and 2 are the JAX
// kernel's profiling cuts: stop after the scan (output the winning slot
// and 1/z) or after the texel fetch (output the quantized texel).
//
// What bounded the first design (one block of 512 threads per tile, 128
// registers, one block an SM; measured with stage_cut on the 1080p map):
// not the card's rate but the heaviest tile. The frame's 255 tiles hold
// 1423 chunk scans and 521,006 covered pixels, yet 60 tiles hold nearly
// all of them and one tile 70 chunks and 8192 covered pixels. A tile was
// one block on one SM, so the kernel took as long as that SM needed for
// the heaviest tile's scan plus its shading, while most SMs idled; evenly
// spread, the same instructions are a fraction of that time. Within the
// block, background lanes waited for covered ones, and params, lights and
// occlusion boxes were re-read from global memory per pixel.
//
// What this design does about it:
// - A tile is a thread block CLUSTER of CL = 8 blocks (the fastest of 2, 4
//   and 8 when measured on the 1080p map), each block of 256 threads owning
//   a horizontal slice of 64/CL rows: the heaviest tile spreads over CL
//   SMs, and small blocks (launch bound: 4 an SM, so at most 64 registers)
//   keep many tiles in flight at once. The shadow variant's lookups raised
//   the kernel to 80 registers and 3 blocks an SM when left to the
//   compiler; held to 4 an SM it fits 64 registers without spilling and
//   every path's kernel got faster (measured on the 1080p map, see
//   PERF.md).
// - The early stop is still ONE decision per 64x128 tile per super, on the
//   same pixels with the same strict `>`: after each scanned super every
//   block publishes min(best) of its slice in its shared memory (warp
//   reduce + one shared atomicMin; best is a positive float, so its bit
//   pattern orders as the value), the cluster barrier orders it, and every
//   block reads the CL values through distributed shared memory. The
//   decision cannot be made finer: s_near is the 1/z plane at the bbox
//   corners rounded as fma(a, x, b*y) + c, while the scan evaluates
//   (a*x + c) + b*y at pixel centres, so it bounds later candidates only up
//   to rounding, and a finer stop could change a winner on the last bit.
//   Likewise the chunk gate stays the tile's box test: the edge planes of a
//   thin sliver can pass by rounding outside its bbox, so a finer gate
//   would test another set of pairs than the TPU kernel.
// - Supers arrive through visibility.cuh's ring of two bulk asynchronous
//   copies (cp.async.bulk + mbarrier): the next super that meets the tile is
//   in flight while this one is scanned; s_near and the supers' tile bits
//   are staged once per block.
// - The scan leaves (best, slot) of the slice's covered pixels compacted in
//   shared memory; the shading then walks that list, thread t taking
//   entries t, t+256, ..., so no lane copies background while its warp
//   shades. Background pixels are written straight from the scan's mapping.
// - params, the frame's light rows (in light-list order) and the occlusion
//   boxes sit in shared memory once per block; the winner's attribute row
//   is read as eight 16-byte loads.
// - No tensor cores: the plane evaluation is an affine form, but wgmma has
//   no exact f32 mode (TF32 keeps 10 mantissa bits) and the edge tests
//   decide coverage on the last bit.
//
// Bit parity with the plain torch version (megakernel.mega_render_reference):
// the file is compiled with -fmad=false and without fast math, so every
// a*b + c rounds twice, as torch's separate elementwise ops do; the plane
// evaluation keeps the kernels' own order (a*xs + c) + b*ys; min/max/clip
// propagate NaN as jnp.minimum/torch.minimum do; light types dispatch at
// run time with the specialised per-type semantics; constants are the f32
// rounding of the same decimal literals. The shadow lookup's products that
// XLA fuses (they pick the texel and decide the depth compare) are written
// as xla_fma, where the plain version writes `_fma`.
//
// The shadow variant: the maps are one flat f32 table (ops/shadow.py's
// layout). Per covered pixel and casting light the lookup offsets the
// receiver along its normal by a texel footprint, picks the cube face and
// texel analytically (or projects into the sun camera), reads ONE texel and
// compares depths. It reads only for live pixels, as the JAX kernel does:
// cube lookups where the pixel lies within the light's range (Chebyshev
// distance below its end; beyond it the light adds nothing), sun lookups
// inside the sun map. The table (1.8 MB on the shadowed 1080p map) stays
// in L2; it is not staged in shared memory.
//
// Transmittance: a map baked with opacity batches carries `steps` (at most
// 4) depth-peeled transparent layers, a depth plane and an alpha plane
// each, laid out like the map itself (ops/shadow.py). For a live pixel the
// lookup walks the layers one (depth, alpha) read pair at a time and
// multiplies the factor, kept in one register, by (1 - alpha) for each
// layer strictly between the light and the receiver (depth < receiver -
// bias) and within the max shadow distance. The walk reuses the texel
// offset of the depth map as one 32-bit offset into the table, so it adds
// the layer index and the factor to the live values of the lookup: held
// to 64 registers, the kernel does not spill (ptxas; other shapes of the
// loop spilled 4-116 bytes, see PERF.md).
//
// The tonemap variant uses the full-precision expf and logf (not __expf):
// the plain version's torch.exp and torch.log on the card are the same
// functions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "visibility.cuh"

// blocks in the thread block cluster that shares one tile
constexpr int CL = 8;

#define SRC_TEXTURE 1.0f
#define SRC_PIXEL 2.0f

// f32 rounding of a decimal constant, as the JAX and torch code get it
#define K(x) ((float)(x))

struct MegaArgs {
    const float* planes;   // (ns*GROUP, 12) sorted candidate planes
    const float* attr;     // (ns*GROUP, n_attr) candidate rows, n_attr % 4 == 0
    const int* sbox;       // (ns, 4) merged super boxes
    const int* cbox;       // (ns*SUPER, 4) merged chunk boxes
    const float* s_near;   // (ns,) per-super near bound, descending
    const uint32_t* atlas; // (n_atlas,) packed RGBA8 texels
    const uint32_t* bg;    // (H, W) packed background
    const float* params;   // (80,)
    const float* lights;   // (L, 24)
    const int* light_list; // (n_lights, 2) [row, type code]
    const float* occ;      // (n_occ, 5)
    const float* ao;       // (H, W) ambient-occlusion factor, or null
    const float* shadow;   // flat shadow-map table, or null
    const int* lshadow;    // (n_lights, 4) [cube base (-1: none), res, trans base (-1: none),
                           // trans steps] per listed light
    uint32_t* rgba;        // (H, W) out
    float* zeff;           // (H, W) out
    int ns, n_attr, n_lights, n_occ, height, width, sample_mode, sun_off, brdf_ggx, stage_cut;
    int sun_base, sun_res;  // the sun map (base -1: none)
    int sun_tbase, sun_steps;  // its transmittance layers (base -1: none)
    int tonemap;            // SceneVM display transform instead of sRGB
    long long n_atlas;
};

// the frame's constants in shared memory (one copy per block)
struct Consts {
    const float* P;    // params (80)
    const float* L;    // n_lights rows of 24, in light-list order
    const int* ltype;  // n_lights type codes
    const float* occ;  // n_occ rows of 5
    const int* lshadow;  // n_lights [cube base, res, trans base, steps], in light-list order
};

__device__ __forceinline__ float jmin(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float jmax(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
    return jmin(jmax(x, lo), hi);
}
__device__ __forceinline__ float srgb_to_linear(float x) {
    return (K(0.6975) * x * x + K(0.3025)) * x;
}
__device__ __forceinline__ float linear_to_srgb(float x) {
    float sq = sqrtf(jmax(x, 0.0f));
    return K(1.055) * sq - K(0.055) * (sq * sq);
}
// the SceneVM display transform, as the JAX kernel writes it
__device__ __forceinline__ float tonemap_scenevm(float x) {
    float t = jmax(x, 0.0f);
    t = t / (t + 1.0f);
    return expf(logf(jmax(t, K(1e-30))) * K(1.0 / 2.2));
}
__device__ __forceinline__ float smoothstep(float e0, float e1, float x) {
    float t = jclip((x - e0) / (e1 - e0), 0.0f, 1.0f);
    return t * t * (3.0f - 2.0f * t);
}
__device__ __forceinline__ float quant(float x) {
    return floorf(jclip(x, 0.0f, 1.0f) * 255.0f + 0.5f);
}

// one texel (or 0 when the flat index leaves the atlas)
__device__ __forceinline__ uint32_t texel(const MegaArgs& a, float rx, float ry,
                                          float x, float y, int atlas_w) {
    long long flat = (long long)(int)(ry + y) * atlas_w + (long long)(int)(rx + x);
    if (flat < 0 || flat >= a.n_atlas) return 0u;
    return __ldg(a.atlas + flat);
}

__device__ __forceinline__ float chan(uint32_t t, int c) {
    return (float)((t >> (8 * c)) & 0xFFu);
}

// the winner's texel color (r, g, b, a) in 0..1 (JAX `_texel_lookup`)
__device__ __forceinline__ void texel_lookup(const MegaArgs& a, float u, float v, const float* row,
                             float repeat, int atlas_w, float out[4]) {
    const float kind = row[18];
    const bool is_tex = kind == SRC_TEXTURE;
    const bool is_pix = kind == SRC_PIXEL;
    const bool ur = (repeat == 1.0f) || (repeat == 2.0f);
    const bool vr = (repeat == 1.0f) || (repeat == 3.0f);
    float uu = ur ? u - floorf(u) : jclip(u, 0.0f, 1.0f);
    float vv = vr ? v - floorf(v) : jclip(v, 0.0f, 1.0f);
    if (!is_tex) { uu = 0.0f; vv = 0.0f; }
    const float rx = row[28], ry = row[29], rw = row[30], rh = row[31];
    float tex[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (is_tex) {
        if (a.sample_mode == 0) {
            float tx = jclip(floorf(uu * (rw - 1.0f) + 0.5f), 0.0f, rw - 1.0f);
            float ty = jclip(floorf(vv * (rh - 1.0f) + 0.5f), 0.0f, rh - 1.0f);
            uint32_t t = texel(a, rx, ry, tx, ty, atlas_w);
            for (int c = 0; c < 4; ++c) tex[c] = chan(t, c);
        } else {
            float x = uu * (rw - 1.0f);
            float y = vv * (rh - 1.0f);
            float x0 = jclip(floorf(x), 0.0f, rw - 1.0f);
            float y0 = jclip(floorf(y), 0.0f, rh - 1.0f);
            float x1 = jmin(x0 + 1.0f, rw - 1.0f);
            float y1 = jmin(y0 + 1.0f, rh - 1.0f);
            float dx = x - floorf(x);
            float dy = y - floorf(y);
            uint32_t t00 = texel(a, rx, ry, x0, y0, atlas_w);
            uint32_t t10 = texel(a, rx, ry, x1, y0, atlas_w);
            uint32_t t01 = texel(a, rx, ry, x0, y1, atlas_w);
            uint32_t t11 = texel(a, rx, ry, x1, y1, atlas_w);
            float w00 = (1.0f - dx) * (1.0f - dy);
            float w10 = dx * (1.0f - dy);
            float w01 = (1.0f - dx) * dy;
            float w11 = dx * dy;
            for (int c = 0; c < 4; ++c) {
                float acc = chan(t00, c) * w00;
                acc = acc + chan(t10, c) * w10;
                acc = acc + chan(t01, c) * w01;
                acc = acc + chan(t11, c) * w11;
                tex[c] = floorf(acc + 0.5f);
            }
        }
    }
    const float is_tex_f = is_tex ? 1.0f : 0.0f;
    const float is_pix_f = is_pix ? 1.0f : 0.0f;
    const float other = 1.0f - is_tex_f - is_pix_f;
    for (int c = 0; c < 4; ++c) {
        float val = is_tex_f * tex[c] * K(1.0 / 255.0) + is_pix_f * row[21 + c];
        if (c == 3) val = val + other;  // SRC_OFF -> opaque black
        out[c] = val;
    }
}

// f32 a*b + c rounded once, as XLA's CPU build fuses it. The plain
// version's `_fma` rounds the exact product's f64 sum to f32, which equals
// this single rounding except where the f64 sum lands on an f32 rounding
// tie (about one sum in 2^29). Written in that f64 form here, the kernel
// needed 4 more registers and, held to 64, spilled.
__device__ __forceinline__ float xla_fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
}

// a*x + b*y + c*z as XLA fuses the chain: fma(c, z, fma(a, x, b*y))
__device__ __forceinline__ float dot3_xla(float x, float y, float z, float a, float b, float c) {
    return xla_fma(z, c, xla_fma(x, a, y * b));
}

// the depth compare of a shadow texel and, with transmittance layers, the
// walk through them: the factor (0 or 1) times (1 - alpha) of every layer
// strictly between the light and the receiver at distance d
__device__ __forceinline__ float shadow_compare(const MegaArgs& a, const float* P, int flat,
                                                int base, float d, int tbase, int steps,
                                                int msize) {
    const float msd = P[59], bias = P[60];
    const float stored = __ldg(a.shadow + flat);
    float factor = ((stored < d - bias) && (d - stored <= msd)) ? 0.0f : 1.0f;
    if (tbase >= 0) {
        // one 32-bit texel offset walks the layers (a 64-bit pointer, or
        // the texel's offset kept apart from the layer's, spilled at 64
        // registers)
        int off = tbase + (flat - base);
        for (int k = 0; k < steps; ++k) {
            const float dk = __ldg(a.shadow + off);
            const float ak = __ldg(a.shadow + off + msize);
            if ((dk < d - bias) && (d - dk <= msd)) factor = factor * (1.0f - ak);
            off += 2 * msize;
        }
    }
    return factor;
}

// the cube-map factor (0 or 1) of one casting light at a covered pixel:
// shadow.shadow_factor's cube branch for a live pixel; 1 outside the
// light's range, where nothing is read
__device__ __forceinline__ float cube_shadow(const MegaArgs& a, const float* P, float wx,
                                             float wy, float wz, float ux, float uy, float uz,
                                             const float* L, const int* ls) {
    const int base = ls[0], res = ls[1];
    const float tpx0 = wx - L[0], tpy0 = wy - L[1], tpz0 = wz - L[2];
    const float ma0 = jmax(fabsf(tpx0), jmax(fabsf(tpy0), fabsf(tpz0)));
    if (!(ma0 < L[5])) return 1.0f;
    const float bias = P[60];
    // the texel footprint 2K/res, a constant of the f32 rounding of 4/res
    const float offs = xla_fma(ma0, (float)(4.0 / (double)res), bias);
    const float tpx = xla_fma(ux, offs, tpx0);
    const float tpy = xla_fma(uy, offs, tpy0);
    const float tpz = xla_fma(uz, offs, tpz0);
    const float ax = fabsf(tpx), ay = fabsf(tpy), az = fabsf(tpz);
    const bool is_x = (ax >= ay) && (ax >= az);
    const bool is_y = !is_x && (ay >= az);
    const float ma = jmax(ax, jmax(ay, az));
    const float sgn_x = tpx >= 0.0f ? 1.0f : -1.0f;
    const float sgn_y = tpy >= 0.0f ? 1.0f : -1.0f;
    const float sgn_z = tpz >= 0.0f ? 1.0f : -1.0f;
    const float u_num = is_x ? -sgn_x * tpz : (is_y ? tpx : -sgn_z * tpx);
    const float v_num = is_x ? tpy : (is_y ? -sgn_y * tpz : tpy);
    const int face = is_x ? (tpx < 0.0f ? 1 : 0)
                          : (is_y ? (tpy < 0.0f ? 3 : 2) : (tpz < 0.0f ? 5 : 4));
    const float ma_safe = jmax(ma, K(1e-20));
    const float half = (float)res * 0.5f;
    const float sx = jclip(floorf(xla_fma(u_num / ma_safe, half, half)), 0.0f, (float)(res - 1));
    const float sy = jclip(floorf(xla_fma(-v_num / ma_safe, half, half)), 0.0f, (float)(res - 1));
    const int flat = base + face * res * res + (int)sy * res + (int)sx;
    return shadow_compare(a, P, flat, base, ma, ls[2], ls[3], 6 * res * res);
}

// the sun map's factor (0 or 1) at a covered pixel: shadow.shadow_factor's
// sun branch; 1 outside the map, where nothing is read
__device__ __forceinline__ float sun_shadow(const MegaArgs& a, const float* P, float wx,
                                            float wy, float wz, float ux, float uy, float uz) {
    const int res = a.sun_res;
    const float bias = P[60], f = P[73];
    const float vz0 = dot3_xla(wx - P[61], wy - P[62], wz - P[63], P[70], P[71], P[72]);
    // the footprint 2K/(f*res) is an f32 product and an f32 division
    const float offs = xla_fma(jmax(vz0, 0.0f), 4.0f / (f * (float)res), bias);
    const float dx = xla_fma(ux, offs, wx) - P[61];
    const float dy = xla_fma(uy, offs, wy) - P[62];
    const float dz = xla_fma(uz, offs, wz) - P[63];
    const float vx = dot3_xla(dx, dy, dz, P[64], P[65], P[66]);
    const float vy = dot3_xla(dx, dy, dz, P[67], P[68], P[69]);
    const float vz = dot3_xla(dx, dy, dz, P[70], P[71], P[72]);
    const float vz_safe = jmax(vz, K(1e-20));
    const float half = (float)res * 0.5f;
    const float sxf = floorf(xla_fma(f * vx / vz_safe, half, half));
    const float syf = floorf(xla_fma(-f * vy / vz_safe, half, half));
    const float fres = (float)res;
    if (!((vz > P[74]) && (sxf >= 0.0f) && (sxf < fres) && (syf >= 0.0f) && (syf < fres)))
        return 1.0f;
    const int flat = a.sun_base + (int)syf * res + (int)sxf;
    return shadow_compare(a, P, flat, a.sun_base, vz, a.sun_tbase, a.sun_steps, res * res);
}

struct Surface {
    float ux, uy, uz;     // shading normal (0 without normals)
    float vdx, vdy, vdz;  // unit view direction
    float base_r, base_g, base_b;  // linear albedo
    float kd_r, kd_g, kd_b;        // base * 0.96
};

// fast Blinn-Phong BRDF with Schlick Fresnel (roughness 0.5, metallic 0)
__device__ __forceinline__ void brdf(const Surface& s, float ldx, float ldy, float ldz,
                                     float rad_r, float rad_g, float rad_b,
                                     float& cr, float& cg, float& cb) {
    float n_dot_l = jmax(s.ux * ldx + s.uy * ldy + s.uz * ldz, 0.0f);
    float hx = ldx + s.vdx, hy = ldy + s.vdy, hz = ldz + s.vdz;
    float hl = sqrtf(hx * hx + hy * hy + hz * hz);
    float inv_hl = 1.0f / jmax(hl, K(1e-30));
    float n_dot_h = jmax((s.ux * hx + s.uy * hy + s.uz * hz) * inv_hl, 0.0f);
    float nh2 = n_dot_h * n_dot_h;
    float spec_b = nh2 * nh2 * nh2;
    float n_dot_v = jmax(s.ux * s.vdx + s.uy * s.vdy + s.uz * s.vdz, 0.0f);
    float x1 = 1.0f - jclip(n_dot_v, 0.0f, 1.0f);
    float x2 = x1 * x1;
    float x5 = x2 * x2 * x1;
    float fr = K(0.04) + K(0.96) * x5;
    float sb = spec_b * n_dot_l;
    bool dead = n_dot_l <= 0.0f;
    cr = dead ? 0.0f : (s.kd_r * n_dot_l + fr * sb) * rad_r;
    cg = dead ? 0.0f : (s.kd_g * n_dot_l + fr * sb) * rad_g;
    cb = dead ? 0.0f : (s.kd_b * n_dot_l + fr * sb) * rad_b;
}

// Cook-Torrance GGX (GGX NDF, Smith G, Schlick Fresnel) with roughness 0.5
// and metallic 0 folded into the constants: a2 = 0.5^4, k = 1.5^2 / 8
__device__ __forceinline__ void brdf_ggx(const Surface& s, float ldx, float ldy, float ldz,
                                         float rad_r, float rad_g, float rad_b,
                                         float& cr, float& cg, float& cb) {
    const float a2 = K(0.0625), k = K(0.28125);
    float n_dot_l = jmax(s.ux * ldx + s.uy * ldy + s.uz * ldz, 0.0f);
    float n_dot_v = jmax(s.ux * s.vdx + s.uy * s.vdy + s.uz * s.vdz, 0.0f);
    float hx = ldx + s.vdx, hy = ldy + s.vdy, hz = ldz + s.vdz;
    float hl = sqrtf(hx * hx + hy * hy + hz * hz);
    float inv_hl = 1.0f / jmax(hl, K(1e-30));
    float n_dot_h = jmax((s.ux * hx + s.uy * hy + s.uz * hz) * inv_hl, 0.0f);
    float denom_d = n_dot_h * n_dot_h * (a2 - 1.0f) + 1.0f;
    float dist = a2 / (K(3.14159265358979) * denom_d * denom_d + K(1e-7));
    float gv = n_dot_v / (n_dot_v * (1.0f - k) + k + K(1e-7));
    float gl = n_dot_l / (n_dot_l * (1.0f - k) + k + K(1e-7));
    float sp = dist * gv * gl / (4.0f * n_dot_l * n_dot_v + K(1e-7));
    float h_dot_v = jmax((hx * s.vdx + hy * s.vdy + hz * s.vdz) * inv_hl, 0.0f);
    float x1 = 1.0f - jclip(h_dot_v, 0.0f, 1.0f);
    float x2 = x1 * x1;
    float x5 = x2 * x2 * x1;
    float fr = K(0.04) + K(0.96) * x5;
    float dd = n_dot_l * K(0.31830988618379);
    float sl = sp * n_dot_l;
    bool dead = n_dot_l <= 0.0f || n_dot_v <= 0.0f;
    cr = dead ? 0.0f : ((1.0f - fr) * dd * s.base_r + fr * sl) * rad_r;
    cg = dead ? 0.0f : ((1.0f - fr) * dd * s.base_g + fr * sl) * rad_g;
    cb = dead ? 0.0f : ((1.0f - fr) * dd * s.base_b + fr * sl) * rad_b;
}

// the frame's direct-light BRDF (block-uniform choice)
__device__ __forceinline__ void light_brdf(const MegaArgs& a, const Surface& s, float ldx,
                                           float ldy, float ldz, float rad_r, float rad_g,
                                           float rad_b, float& cr, float& cg, float& cb) {
    if (a.brdf_ggx)
        brdf_ggx(s, ldx, ldy, ldz, rad_r, rad_g, rad_b, cr, cg, cb);
    else
        brdf(s, ldx, ldy, ldz, rad_r, rad_g, rad_b, cr, cg, cb);
}

// stages 2-6 for one covered pixel -> packed RGBA8 (or the background)
__device__ __forceinline__ void shade_pixel(const MegaArgs& a, const Consts& k, int gx, int gy,
                                            float best, int slot) {
    const size_t o = (size_t)gy * a.width + gx;
    const float* P = k.P;
    float A[32];
    {
        const float4* row = reinterpret_cast<const float4*>(a.attr + (size_t)slot * a.n_attr);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float4 v = __ldg(row + i);
            A[4 * i] = v.x;
            A[4 * i + 1] = v.y;
            A[4 * i + 2] = v.z;
            A[4 * i + 3] = v.w;
        }
    }
    const float z = 1.0f / best;
    const float xg = (float)gx + 0.5f;
    const float yg = (float)gy + 0.5f;

    // ---- stage 2: plane interpolation ----
    float interp[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) interp[i] = A[3 * i] * xg + A[3 * i + 1] * yg + A[3 * i + 2];
    const float inv_w = interp[0];
    const float safe_w = inv_w == 0.0f ? 1.0f : inv_w;
    const float u = interp[1] / safe_w;
    const float v = interp[2] / safe_w;
    const float nx = interp[3], ny = interp[4], nz = interp[5];
    const float fullbright = A[19] >= 4.0f ? 1.0f : 0.0f;
    const float repeat = A[19] - 4.0f * fullbright;

    // ---- stage 3: texel resolve ----
    float tex[4];
    texel_lookup(a, u, v, A, repeat, (int)P[54], tex);
    if (a.stage_cut == 2) {  // profiling: the quantized texel, no shading
        a.rgba[o] = (uint32_t)quant(tex[0]) | ((uint32_t)quant(tex[1]) << 8) |
                    ((uint32_t)quant(tex[2]) << 16) | ((uint32_t)quant(tex[3]) << 24);
        a.zeff[o] = best;
        return;
    }

    // ---- stage 4: lighting ----
    const float x_ndc = 2.0f * (xg / P[41]) - 1.0f;
    const float y_ndc = 1.0f - 2.0f * (yg / P[42]);
    float vr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
        vr[r] = P[4 * r] * x_ndc + P[4 * r + 1] * y_ndc + P[4 * r + 2] * z + P[4 * r + 3];
    const float inv_vw = 1.0f / vr[3];
    const float vx = vr[0] * inv_vw, vy = vr[1] * inv_vw, vz = vr[2] * inv_vw;
    float wp[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
        wp[r] = P[16 + 4 * r] * vx + P[17 + 4 * r] * vy + P[18 + 4 * r] * vz + P[19 + 4 * r];
    const float wx = wp[0], wy = wp[1], wz = wp[2];

    Surface s;
    float vdx = P[32] - wx, vdy = P[33] - wy, vdz = P[34] - wz;
    const float vlen = sqrtf(vdx * vdx + vdy * vdy + vdz * vdz);
    const float inv_vlen = 1.0f / jmax(vlen, K(1e-30));
    s.vdx = vdx * inv_vlen;
    s.vdy = vdy * inv_vlen;
    s.vdz = vdz * inv_vlen;
    const float nlen = sqrtf(nx * nx + ny * ny + nz * nz);
    const float inv_nlen = 1.0f / jmax(nlen, K(1e-30));
    float ux = nx * inv_nlen, uy = ny * inv_nlen, uz = nz * inv_nlen;
    const float flip = (ux * s.vdx + uy * s.vdy + uz * s.vdz < 0.0f) ? -1.0f : 1.0f;
    const bool n_ok = A[20] > 0.5f;
    s.ux = n_ok ? ux * flip : 0.0f;
    s.uy = n_ok ? uy * flip : 0.0f;
    s.uz = n_ok ? uz * flip : 0.0f;
    s.base_r = srgb_to_linear(tex[0]);
    s.base_g = srgb_to_linear(tex[1]);
    s.base_b = srgb_to_linear(tex[2]);
    s.kd_r = s.base_r * K(0.96);
    s.kd_g = s.base_g * K(0.96);
    s.kd_b = s.base_b * K(0.96);
    float hemi = 0.5f * (s.uy + 1.0f);
    // the ambient-occlusion factor scales only the two terms hemi feeds
    // (the hemisphere and the batch ambient)
    if (a.ao) hemi = hemi * __ldg(a.ao + o);

    float occlusion = 1.0f;
    for (int bi = 0; bi < a.n_occ; ++bi) {
        const float* b = k.occ + 5 * bi;
        bool inside = (wx >= b[0]) && (wz >= b[1]) && (wx <= b[2]) && (wz <= b[3]);
        occlusion = jmin(occlusion, inside ? b[4] : 1.0f);
    }

    float lit_r = P[35] * P[36] * s.kd_r * hemi;
    float lit_g = P[35] * P[37] * s.kd_g * hemi;
    float lit_b = P[35] * P[38] * s.kd_b * hemi;
    if (!a.sun_off) {
        float sdx = -P[44], sdy = -P[45], sdz = -P[46];
        float slen = sqrtf(sdx * sdx + sdy * sdy + sdz * sdz);
        float inv_slen = 1.0f / jmax(slen, K(1e-30));
        float day = P[47];
        float sr, sg, sb;
        float day_r = day * P[55], day_g = day * P[56], day_b = day * P[57];
        if (a.shadow && a.sun_base >= 0) {
            const float sf = sun_shadow(a, P, wx, wy, wz, s.ux, s.uy, s.uz);
            day_r = day_r * sf;
            day_g = day_g * sf;
            day_b = day_b * sf;
        }
        light_brdf(a, s, sdx * inv_slen, sdy * inv_slen, sdz * inv_slen, day_r, day_g, day_b,
                   sr, sg, sb);
        lit_r = lit_r + P[43] * sr;
        lit_g = lit_g + P[43] * sg;
        lit_b = lit_b + P[43] * sb;
    }
    lit_r = lit_r * occlusion;
    lit_g = lit_g * occlusion;
    lit_b = lit_b * occlusion;
    lit_r = lit_r + A[25] * s.kd_r * hemi;
    lit_g = lit_g + A[26] * s.kd_g * hemi;
    lit_b = lit_b + A[27] * s.kd_b * hemi;

    for (int n = 0; n < a.n_lights; ++n) {
        const int lt = k.ltype[n];
        const float* L = k.L + 24 * n;
        const float start = L[4], end = L[5], intensity = L[6], valid = L[20];
        const float tpx = wx - L[0], tpy = wy - L[1], tpz = wz - L[2];
        const float dist = sqrtf(tpx * tpx + tpy * tpy + tpz * tpz);
        const float inv_dist = 1.0f / jmax(dist, K(1e-20));
        const float rng_f = dist < end ? 1.0f : 0.0f;
        const float near_f = dist <= start ? 1.0f : 0.0f;
        const bool is_amb = lt == 1 || lt == 2;
        float smooth_att = 0.0f, angle_att = 0.0f, scale, ok_f, spot_ok_f = 0.0f;
        if (lt != 1 && lt != 2 && lt != 3)  // point, area, daylight
            smooth_att = near_f + (1.0f - near_f) * smoothstep(end, start, dist);
        if (lt >= 4)  // area, daylight
            angle_att = jmax((L[16] * tpx + L[17] * tpy + L[18] * tpz) * inv_dist, 0.0f);
        if (lt == 0) {
            scale = intensity * smooth_att;
        } else if (is_amb) {
            scale = intensity;
        } else if (lt == 3) {
            float lin_att = near_f + (1.0f - near_f) *
                (1.0f - (dist - start) / jmax(end - start, K(1e-20)));
            float cosang = jclip((L[10] * tpx + L[11] * tpy + L[12] * tpz) * inv_dist,
                                 -1.0f, 1.0f);
            spot_ok_f = cosang >= L[13] ? 1.0f : 0.0f;
            scale = spot_ok_f * intensity * lin_att;
        } else if (lt == 4) {
            float area = L[14] * L[15];
            float area_main = angle_att * smooth_att * area * intensity;
            float area_linedef = smooth_att * area * intensity;
            float area_c = L[19] * area_linedef + (1.0f - L[19]) * area_main;
            float inner_f = dist < K(0.1) ? 1.0f : 0.0f;
            scale = inner_f + (1.0f - inner_f) * area_c;
        } else {
            scale = angle_att * smooth_att * intensity;
        }
        if (is_amb) ok_f = valid;
        else if (lt == 3) ok_f = valid * rng_f * spot_ok_f;
        else ok_f = valid * rng_f;
        const float ldx = -tpx * inv_dist, ldy = -tpy * inv_dist, ldz = -tpz * inv_dist;
        float rad;
        if (lt == 0 || lt == 3 || lt == 4) {
            float lam = jmax(s.ux * ldx + s.uy * ldy + s.uz * ldz, 0.0f);
            rad = ok_f * scale * lam;
        } else {
            rad = ok_f * scale * 1.0f;
        }
        if (a.shadow && k.lshadow[4 * n] >= 0)
            rad = rad * cube_shadow(a, P, wx, wy, wz, s.ux, s.uy, s.uz, L, k.lshadow + 4 * n);
        const float rad_r = L[7] * rad, rad_g = L[8] * rad, rad_b = L[9] * rad;
        float cr, cg, cb;
        light_brdf(a, s, ldx, ldy, ldz, rad_r, rad_g, rad_b, cr, cg, cb);
        // has_rad gate: a light with zero radiance adds nothing, even NaN
        const float has_rad = (rad_r != 0.0f || rad_g != 0.0f || rad_b != 0.0f) ? 1.0f : 0.0f;
        lit_r = lit_r + has_rad * cr;
        lit_g = lit_g + has_rad * cg;
        lit_b = lit_b + has_rad * cb;
    }

    float out_r, out_g, out_b;
    if (a.tonemap) {
        out_r = tonemap_scenevm(lit_r);
        out_g = tonemap_scenevm(lit_g);
        out_b = tonemap_scenevm(lit_b);
    } else {
        out_r = linear_to_srgb(lit_r);
        out_g = linear_to_srgb(lit_g);
        out_b = linear_to_srgb(lit_b);
    }
    // fullbright batches bypass lighting entirely (raw sRGB texel)
    out_r = fullbright * tex[0] + (1.0f - fullbright) * out_r;
    out_g = fullbright * tex[1] + (1.0f - fullbright) * out_g;
    out_b = fullbright * tex[2] + (1.0f - fullbright) * out_b;

    // ---- stage 5: distance fog (linear node fade or SceneVM exp^2) ----
    const float fog_lin = jclip((vlen - P[52]) / P[53], 0.0f, 1.0f);
    const float fog_exp = 1.0f - expf(-P[77] * vlen * vlen);
    const float fog_t = P[48] * (P[76] * fog_exp + (1.0f - P[76]) * fog_lin);
    out_r = out_r * (1.0f - fog_t) + P[49] * fog_t;
    out_g = out_g * (1.0f - fog_t) + P[50] * fog_t;
    out_b = out_b * (1.0f - fog_t) + P[51] * fog_t;

    // ---- stage 6: compose + RGBA8 pack ----
    const float a_u8 = quant(tex[3]);
    if (a_u8 >= 255.0f) {
        a.rgba[o] = (uint32_t)quant(out_r) | ((uint32_t)quant(out_g) << 8) |
                    ((uint32_t)quant(out_b) << 16) | ((uint32_t)a_u8 << 24);
        a.zeff[o] = z;
    } else {
        a.rgba[o] = __ldg(a.bg + o);
        a.zeff[o] = 1.0f;
    }
}

// what a block shares with its cluster and keeps across the phases
struct __align__(16) BlockState {
    uint32_t bmin[3];   // min(best) of the slice per super, bit pattern, 3 slots in turn
    uint32_t hit;       // does any pixel of the slice have a winner?
    int count;          // covered in-frame pixels of the slice (the shading list's length)
    int pad[3];
};

// shared memory, in this order: ScanRing | BlockState | list best (f32),
// slot (i32) x pixels of the slice | s_near (ns) | meet bits ((ns+31)/32) |
// params (80) | lights (n_lights*24) | light types (n_lights) | occlusion
// boxes (n_occ*5) | cube maps of the lights (n_lights*4) | list pixel
// (u16) x pixels of the slice
static size_t mega_smem_bytes(int ns, int n_lights, int n_occ) {
    const size_t px = (size_t)SLICE_ROWS(CL) * TILE_W;
    return sizeof(ScanRing) + sizeof(BlockState) + px * 12 + 4 * (size_t)ns +
           4 * (size_t)((ns + 31) / 32) + 4 * (80 + 29 * (size_t)n_lights + 5 * (size_t)n_occ) +
           16;
}

__global__ void __launch_bounds__(THREADS, 4) mega_kernel(const MegaArgs a) {
    constexpr int PPT = SLICE_PPT(CL);
    constexpr int PX = SLICE_ROWS(CL) * TILE_W;
    extern __shared__ __align__(16) unsigned char mega_smem[];
    ScanRing* ring = reinterpret_cast<ScanRing*>(mega_smem);
    BlockState* st = reinterpret_cast<BlockState*>(mega_smem + sizeof(ScanRing));
    float* l_best = reinterpret_cast<float*>(st + 1);
    int* l_slot = reinterpret_cast<int*>(l_best + PX);
    float* s_sn = reinterpret_cast<float*>(l_slot + PX);
    uint32_t* meet = reinterpret_cast<uint32_t*>(s_sn + a.ns);
    float* c_params = reinterpret_cast<float*>(meet + (a.ns + 31) / 32);
    float* c_lights = c_params + 80;
    int* c_ltype = reinterpret_cast<int*>(c_lights + 24 * a.n_lights);
    float* c_occ = reinterpret_cast<float*>(c_ltype + a.n_lights);
    int* c_lshadow = reinterpret_cast<int*>(c_occ + 5 * a.n_occ);
    unsigned short* l_pix = reinterpret_cast<unsigned short*>(c_lshadow + 4 * a.n_lights);

    const int x0 = blockIdx.x * TILE_W;
    const int y0 = (blockIdx.y / CL) * TILE_H;
    const int slice = blockIdx.y % CL;
    const int tid = threadIdx.x;

    float xs, ys[PPT], best[PPT];
    int idx[PPT];
    slice_pixels<PPT>(x0, y0, slice, xs, ys, best, idx);

    // ---- set-up: the supers' tile bits and s_near ----
    supers_meeting_tile(meet, a.sbox, a.ns, x0, y0);
    for (int i = tid; i < a.ns; i += THREADS) s_sn[i] = __ldg(a.s_near + i);
    if (tid == 0) {
        mbar_init(&ring->mbar[0], 1);
        mbar_init(&ring->mbar[1], 1);
        mbar_init_fence();
        st->bmin[0] = 0x7F800000u;  // +inf
        st->bmin[1] = 0x7F800000u;
        st->bmin[2] = 0x7F800000u;
        st->hit = 0u;
        st->count = 0;
    }
    __syncthreads();

    // ---- stage 1: front-to-back visibility scan with the tile's early stop ----
    // Every block of the cluster walks the same supers: the gates and the
    // stop depend only on the tile and on the tile's min(best). A cluster
    // barrier is passed only between two scanned supers, so a tile that
    // scans at most one super (most of a frame) passes none.
    float minb = 1.0f;
    bool shared_state = false;  // did the cluster read each other's memory?
    int cur = next_super(meet, 0, a.ns);
    if (cur < a.ns && tid == 0) ring_start(ring, 0, a.planes, a.cbox, cur);
    int k = 0;
    for (; cur < a.ns; ++k) {
        // strict >: a super at exactly min(best) cannot win
        if (!(s_sn[cur] > minb)) break;
        const int nxt = next_super(meet, cur + 1, a.ns);
        if (tid == 0) {
            // slot (k+1)&1 was scanned in iteration k-1, bmin slot (k+1)%3
            // read in iteration k-2: a cluster barrier lies behind both
            if (nxt < a.ns) ring_start(ring, (k + 1) & 1, a.planes, a.cbox, nxt);
            st->bmin[(k + 1) % 3] = 0x7F800000u;
        }
        mbar_wait(&ring->mbar[k & 1], (k >> 1) & 1);
        scan_super<PPT>(ring->planes[k & 1], ring->cbox[k & 1], cur, x0, y0, xs, ys, best, idx);
        cur = nxt;
        if (cur >= a.ns) break;  // the bound only matters while supers remain
        // the tile's min winning 1/z: slice min -> own shared slot -> cluster
        float m = best[0];
#pragma unroll
        for (int r = 1; r < PPT; ++r) m = fminf(m, best[r]);
        for (int off = 16; off > 0; off >>= 1)
            m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if ((tid & 31) == 0) atomicMin(&st->bmin[k % 3], __float_as_uint(m));
        cluster_arrive();
        cluster_wait();
        uint32_t mm = 0x7F800000u;
#pragma unroll
        for (int r = 0; r < CL; ++r) mm = min(mm, cluster_load(&st->bmin[k % 3], r));
        minb = __uint_as_float(mm);
        shared_state = true;
    }
    // the early stop can leave with super `cur` still in flight into slot
    // k&1: drain it, so that no copy lands after the block has gone
    if (cur < a.ns) mbar_wait(&ring->mbar[k & 1], (k >> 1) & 1);

    // stage_cut 2 shades a tile when any of its pixels, padding included,
    // has a winner: one more exchange across the cluster
    uint32_t tile_hit = 0u;
    if (a.stage_cut == 2) {
        bool any_hit = false;
#pragma unroll
        for (int r = 0; r < PPT; ++r) any_hit |= idx[r] >= 0;
        if (__any_sync(0xffffffffu, any_hit) && (tid & 31) == 0) st->hit = 1u;
        cluster_arrive();
        cluster_wait();
#pragma unroll
        for (int r = 0; r < CL; ++r) tile_hit |= cluster_load(&st->hit, r);
        shared_state = true;
    }
    // paired with the wait before the block ends: no block leaves while its
    // shared memory may still be read
    if (shared_state) cluster_arrive();

    // ---- the slice's winners: background out, covered pixels into the list ----
    const int gx = x0 + tid % TILE_W;
#pragma unroll
    for (int r = 0; r < PPT; ++r) {
        const int row = slice_row<PPT>(slice, r);
        const int gy = y0 + row;
        const bool inside = gx < a.width && gy < a.height;
        const size_t o = (size_t)gy * a.width + gx;
        const bool covered = inside && idx[r] >= 0 && a.stage_cut != 1;
        if (inside && !covered) {
            if (a.stage_cut == 1) {  // profiling: the scan's winners
                a.rgba[o] = (uint32_t)idx[r];
                a.zeff[o] = best[r];
            } else if (a.stage_cut == 2 && tile_hit) {
                // no winner in a tile that shades: zero attributes, so
                // SRC_OFF's opaque black
                a.rgba[o] = 0xFF000000u;
                a.zeff[o] = best[r];
            } else {
                a.rgba[o] = __ldg(a.bg + o);
                a.zeff[o] = 1.0f;
            }
        }
        const uint32_t mask = __ballot_sync(0xffffffffu, covered);
        if (mask) {
            int base = 0;
            if ((tid & 31) == 0) base = atomicAdd(&st->count, __popc(mask));
            base = __shfl_sync(0xffffffffu, base, 0);
            if (covered) {
                const int pos = base + __popc(mask & ((1u << (tid & 31)) - 1u));
                l_best[pos] = best[r];
                l_slot[pos] = idx[r];
                l_pix[pos] = (unsigned short)((row - slice * SLICE_ROWS(CL)) * TILE_W + tid % TILE_W);
            }
        }
    }
    __syncthreads();

    // ---- stages 2-6 over the compacted list ----
    const int count = st->count;
    if (count > 0) {
        // the frame's constants, staged only by blocks that shade
        for (int i = tid; i < 80; i += THREADS) c_params[i] = __ldg(a.params + i);
        for (int i = tid; i < 24 * a.n_lights; i += THREADS)
            c_lights[i] = __ldg(a.lights + 24 * __ldg(a.light_list + 2 * (i / 24)) + i % 24);
        for (int i = tid; i < a.n_lights; i += THREADS)
            c_ltype[i] = __ldg(a.light_list + 2 * i + 1);
        for (int i = tid; i < 5 * a.n_occ; i += THREADS) c_occ[i] = __ldg(a.occ + i);
        if (a.shadow)
            for (int i = tid; i < 4 * a.n_lights; i += THREADS) c_lshadow[i] = __ldg(a.lshadow + i);
        __syncthreads();
        Consts kc;
        kc.P = c_params;
        kc.L = c_lights;
        kc.ltype = c_ltype;
        kc.occ = c_occ;
        kc.lshadow = c_lshadow;
        for (int i = tid; i < count; i += THREADS) {
            const int pix = l_pix[i];
            shade_pixel(a, kc, x0 + pix % TILE_W, y0 + slice * SLICE_ROWS(CL) + pix / TILE_W,
                        l_best[i], l_slot[i]);
        }
    }
    if (shared_state) cluster_wait();
}

static int launch_mega(const MegaArgs& a, cudaStream_t stream) {
    const size_t smem = mega_smem_bytes(a.ns, a.n_lights, a.n_occ);
    cudaError_t err = cudaFuncSetAttribute(mega_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.width + TILE_W - 1) / TILE_W, ((a.height + TILE_H - 1) / TILE_H) * CL);
    return launch_clustered(mega_kernel, grid, THREADS, smem, stream, dim3(1, CL, 1), a);
}

// shared memory a block needs for this frame
extern "C" long long rx_mega_smem_bytes(int ns, int n_lights, int n_occ) {
    return (long long)mega_smem_bytes(ns, n_lights, n_occ);
}

// out[0..3]: registers, static and dynamic shared memory of the kernel for
// this frame, and the blocks an SM holds at once
extern "C" int rx_mega_resources(int ns, int n_lights, int n_occ, int* out) {
    return kernel_resources(mega_kernel, THREADS, mega_smem_bytes(ns, n_lights, n_occ), out);
}

extern "C" int rx_mega_render(
    const float* planes, const float* attr, const int* sbox, const int* cbox,
    const float* s_near, const int* atlas, const int* bg, const float* params,
    const float* lights, const int* light_list, const float* occ, const float* ao,
    const float* shadow, const int* lshadow, int* rgba, float* zeff, int ns, int n_attr,
    long long n_atlas, int n_lights, int n_occ, int height, int width, int sample_mode,
    int sun_off, int brdf_ggx, int stage_cut, int sun_base, int sun_res, int sun_tbase,
    int sun_steps, int tonemap, void* stream) {
    MegaArgs a;
    a.planes = planes;
    a.attr = attr;
    a.sbox = sbox;
    a.cbox = cbox;
    a.s_near = s_near;
    a.atlas = reinterpret_cast<const uint32_t*>(atlas);
    a.bg = reinterpret_cast<const uint32_t*>(bg);
    a.params = params;
    a.lights = lights;
    a.light_list = light_list;
    a.occ = occ;
    a.ao = ao;
    a.shadow = shadow;
    a.lshadow = lshadow;
    a.sun_base = shadow ? sun_base : -1;
    a.sun_res = sun_res;
    a.sun_tbase = sun_tbase;
    a.sun_steps = sun_steps;
    a.tonemap = tonemap;
    a.rgba = reinterpret_cast<uint32_t*>(rgba);
    a.zeff = zeff;
    a.ns = ns;
    a.n_attr = n_attr;
    a.n_atlas = n_atlas;
    a.n_lights = n_lights;
    a.n_occ = n_occ;
    a.height = height;
    a.width = width;
    a.sample_mode = sample_mode;
    a.sun_off = sun_off;
    a.brdf_ggx = brdf_ggx;
    a.stage_cut = stage_cut;
    return launch_mega(a, static_cast<cudaStream_t>(stream));
}

// B1's lookup FMA (xla_fma) over n elements, so that it can be held to the
// plain version's `_fma` on the card
__global__ void xla_fma_kernel(const float* a, const float* b, const float* c, float* out,
                               long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = xla_fma(a[i], b[i], c[i]);
}

extern "C" int rx_xla_fma(const float* a, const float* b, const float* c, float* out,
                          long long n, void* stream) {
    if (n <= 0) return 0;
    xla_fma_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        a, b, c, out, n);
    return (int)cudaGetLastError();
}

extern "C" const char* rx_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

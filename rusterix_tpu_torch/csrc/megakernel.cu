// Opaque-frame megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mega_kernel` in rusterix_tpu/ops/megakernel.py
// (launched by `mega_render` there): for one 64x128 screen tile it runs, in
// one program, (1) the front-to-back hierarchical visibility scan over
// Morton-sorted super-chunks of 128 candidate slots and chunks of 4, with
// max 1/z and a strict `>`, (2) plane interpolation of 1/w, u, v and the
// normal, (3) the atlas texel fetch, nearest or bilinear, with the repeat
// modes, (4) the lighting chain (hemisphere ambient, sun with the fast
// BRDF, occlusion boxes, batch ambient and the five light types), (5)
// linear or exp^2 fog, and (6) the composite over the background and the
// RGBA8 pack. Outputs: packed RGBA8 per pixel and the effective z (1.0
// where the opaque pass did not write).
//
// What bounds it on the card: the visibility scan is ALU-bound on the edge
// tests (four plane evaluations per candidate per pixel); the winner's
// attribute row and the texel reads are latency-bound gathers that the
// 50 MB L2 serves (the whole candidate table and atlas of a map scene are
// a few MB).
//
// What the simple design does about it: one block per 64x128 tile, so
// the tile's early stop is decided on exactly the pixels the TPU kernel
// decided it on. Each of the 512 threads owns one column and 16 rows of
// the tile; it evaluates a*x + c once per candidate and adds b*y per row.
// A super's 128 plane rows are staged in shared memory once and read as
// broadcasts; the super and chunk boxes gate the block uniformly; after
// each scanned super a block reduction gives min(best) and the scan stops
// when s_near[s] <= min(best). Winners are tracked as a slot index and the
// attribute row is read once per pixel from global memory. The texel fetch
// is a direct gather on the flat u32 atlas.
//
// Bit parity with the plain torch version (megakernel.mega_render_reference):
// the file is compiled with -fmad=false and without fast math, so every
// a*b + c rounds twice, as torch's separate elementwise ops do; the plane
// evaluation keeps the kernels' own order (a*xs + c) + b*ys; min/max/clip
// propagate NaN as jnp.minimum/torch.minimum do; light types dispatch at
// run time with the specialised per-type semantics; constants are the f32
// rounding of the same decimal literals.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_H 64
#define TILE_W 128
#define CHUNK 4
#define SUPER 32
#define GROUP (CHUNK * SUPER)
#define THREADS 512
#define ROWS_PER_STEP (THREADS / TILE_W)   // 4 rows of the tile per step
#define PPT (TILE_H / ROWS_PER_STEP)        // 16 pixels per thread

#define SRC_TEXTURE 1.0f
#define SRC_PIXEL 2.0f

// f32 rounding of a decimal constant, as the JAX and torch code get it
#define K(x) ((float)(x))

struct MegaArgs {
    const float* planes;   // (ns*GROUP, 12) sorted candidate planes
    const float* attr;     // (ns*GROUP, n_attr) candidate rows
    const int* sbox;       // (ns, 4) merged super boxes
    const int* cbox;       // (ns*SUPER, 4) merged chunk boxes
    const float* s_near;   // (ns,) per-super near bound, descending
    const uint32_t* atlas; // (n_atlas,) packed RGBA8 texels
    const uint32_t* bg;    // (H, W) packed background
    const float* params;   // (80,)
    const float* lights;   // (L, 24)
    const int* light_list; // (n_lights, 2) [row, type code]
    const float* occ;      // (n_occ, 5)
    uint32_t* rgba;        // (H, W) out
    float* zeff;           // (H, W) out
    int ns, n_attr, n_lights, n_occ, height, width, sample_mode, sun_off;
    long long n_atlas;
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

struct Surface {
    float ux, uy, uz;     // shading normal (0 without normals)
    float vdx, vdy, vdz;  // unit view direction
    float kd_r, kd_g, kd_b;
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

// stages 2-6 for one covered pixel -> packed RGBA8 (or the background)
__device__ __noinline__ void shade_pixel(const MegaArgs& a, int gx, int gy, float best,
                                         int slot) {
    const size_t o = (size_t)gy * a.width + gx;
    if (slot < 0) {
        a.rgba[o] = __ldg(a.bg + o);
        a.zeff[o] = 1.0f;
        return;
    }
    const float* P = a.params;
    const float* row = a.attr + (size_t)slot * a.n_attr;
    float A[32];
    for (int i = 0; i < 32; ++i) A[i] = __ldg(row + i);
    const float z = 1.0f / best;
    const float xg = (float)gx + 0.5f;
    const float yg = (float)gy + 0.5f;

    // ---- stage 2: plane interpolation ----
    float interp[6];
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

    // ---- stage 4: lighting ----
    const float x_ndc = 2.0f * (xg / P[41]) - 1.0f;
    const float y_ndc = 1.0f - 2.0f * (yg / P[42]);
    float vr[4];
    for (int r = 0; r < 4; ++r)
        vr[r] = P[4 * r] * x_ndc + P[4 * r + 1] * y_ndc + P[4 * r + 2] * z + P[4 * r + 3];
    const float inv_vw = 1.0f / vr[3];
    const float vx = vr[0] * inv_vw, vy = vr[1] * inv_vw, vz = vr[2] * inv_vw;
    float wp[3];
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
    s.kd_r = srgb_to_linear(tex[0]) * K(0.96);
    s.kd_g = srgb_to_linear(tex[1]) * K(0.96);
    s.kd_b = srgb_to_linear(tex[2]) * K(0.96);
    const float hemi = 0.5f * (s.uy + 1.0f);

    float occlusion = 1.0f;
    for (int bi = 0; bi < a.n_occ; ++bi) {
        const float* b = a.occ + 5 * bi;
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
        brdf(s, sdx * inv_slen, sdy * inv_slen, sdz * inv_slen, day * P[55], day * P[56],
             day * P[57], sr, sg, sb);
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
        const int lt = a.light_list[2 * n + 1];
        const float* L = a.lights + 24 * a.light_list[2 * n];
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
        const float rad_r = L[7] * rad, rad_g = L[8] * rad, rad_b = L[9] * rad;
        float cr, cg, cb;
        brdf(s, ldx, ldy, ldz, rad_r, rad_g, rad_b, cr, cg, cb);
        // has_rad gate: a light with zero radiance adds nothing, even NaN
        const float has_rad = (rad_r != 0.0f || rad_g != 0.0f || rad_b != 0.0f) ? 1.0f : 0.0f;
        lit_r = lit_r + has_rad * cr;
        lit_g = lit_g + has_rad * cg;
        lit_b = lit_b + has_rad * cb;
    }

    float out_r = linear_to_srgb(lit_r);
    float out_g = linear_to_srgb(lit_g);
    float out_b = linear_to_srgb(lit_b);
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

__global__ void __launch_bounds__(THREADS) mega_kernel(const MegaArgs a) {
    __shared__ float s_planes[GROUP * 12];
    __shared__ float s_red[THREADS / 32];
    __shared__ float s_minb;

    const int x0 = blockIdx.x * TILE_W;
    const int y0 = blockIdx.y * TILE_H;
    const int tid = threadIdx.x;
    const int lx = tid % TILE_W;
    const int ly = tid / TILE_W;

    // pixel centres; padded pixels past the frame take part in the scan
    // and in min(best) exactly as in the TPU kernel's padded tile
    const float xs = (float)lx + ((float)x0 + 0.5f);
    float ys[PPT], best[PPT];
    int idx[PPT];
#pragma unroll
    for (int r = 0; r < PPT; ++r) {
        ys[r] = (float)(ly + r * ROWS_PER_STEP) + ((float)y0 + 0.5f);
        best[r] = 1.0f;
        idx[r] = -1;
    }
    if (tid == 0) s_minb = 1.0f;
    __syncthreads();

    // ---- stage 1: front-to-back visibility scan ----
    for (int s = 0; s < a.ns; ++s) {
        const int* sb = a.sbox + 4 * s;
        if (!(sb[0] < x0 + TILE_W && sb[2] > x0 && sb[1] < y0 + TILE_H && sb[3] > y0))
            continue;
        // strict >: a super at exactly min(best) cannot win
        if (!(a.s_near[s] > s_minb)) break;
        const float* src = a.planes + (size_t)s * GROUP * 12;
        for (int i = tid; i < GROUP * 12; i += THREADS) s_planes[i] = src[i];
        __syncthreads();
        for (int c = 0; c < SUPER; ++c) {
            const int* cb = a.cbox + 4 * (s * SUPER + c);
            if (!(cb[0] < x0 + TILE_W && cb[2] > x0 && cb[1] < y0 + TILE_H && cb[3] > y0))
                continue;
            for (int k = 0; k < CHUNK; ++k) {
                const float* p = s_planes + (c * CHUNK + k) * 12;
                const int slot = (s * SUPER + c) * CHUNK + k;
                // (a*xs + c) + b*ys, each op rounded on its own
                const float r0 = __fadd_rn(__fmul_rn(p[0], xs), p[2]);
                const float r1 = __fadd_rn(__fmul_rn(p[3], xs), p[5]);
                const float r2 = __fadd_rn(__fmul_rn(p[6], xs), p[8]);
                const float r3 = __fadd_rn(__fmul_rn(p[9], xs), p[11]);
#pragma unroll
                for (int r = 0; r < PPT; ++r) {
                    const float e0 = __fadd_rn(r0, __fmul_rn(p[1], ys[r]));
                    const float e1 = __fadd_rn(r1, __fmul_rn(p[4], ys[r]));
                    const float e2 = __fadd_rn(r2, __fmul_rn(p[7], ys[r]));
                    const float invz = __fadd_rn(r3, __fmul_rn(p[10], ys[r]));
                    if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && invz > best[r]) {
                        best[r] = invz;
                        idx[r] = slot;
                    }
                }
            }
        }
        // the tile's min winning 1/z for the early stop
        float m = best[0];
#pragma unroll
        for (int r = 1; r < PPT; ++r) m = fminf(m, best[r]);
        for (int off = 16; off > 0; off >>= 1)
            m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if ((tid & 31) == 0) s_red[tid >> 5] = m;
        __syncthreads();
        if (tid == 0) {
            float mm = s_red[0];
            for (int w = 1; w < THREADS / 32; ++w) mm = fminf(mm, s_red[w]);
            s_minb = mm;
        }
        __syncthreads();
    }

    // ---- stages 2-6 per pixel that lies inside the frame ----
    const int gx = x0 + lx;
    if (gx >= a.width) return;
#pragma unroll
    for (int r = 0; r < PPT; ++r) {
        const int gy = y0 + ly + r * ROWS_PER_STEP;
        if (gy < a.height) shade_pixel(a, gx, gy, best[r], idx[r]);
    }
}

extern "C" int rx_mega_render(
    const float* planes, const float* attr, const int* sbox, const int* cbox,
    const float* s_near, const int* atlas, const int* bg, const float* params,
    const float* lights, const int* light_list, const float* occ, int* rgba,
    float* zeff, int ns, int n_attr, long long n_atlas, int n_lights, int n_occ,
    int height, int width, int sample_mode, int sun_off, void* stream) {
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
    dim3 grid((width + TILE_W - 1) / TILE_W, (height + TILE_H - 1) / TILE_H);
    mega_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

extern "C" const char* rx_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

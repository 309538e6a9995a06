// Secondary-ray closest-hit kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rt_kernel` in rusterix_tpu/ops/rt_kernel.py
// (launched by `intersect_rays_pallas` there): one block per 8x128 ray
// block walks the block's distance-ordered shortlist of 64-triangle cells
// while the next entry's t lower bound is below the block's bound. Per
// visited cell every ray slab-tests the cell box; when any live ray enters
// closer than min(best, its scene-exit cap), the block runs Möller-Trumbore
// of all its rays against the cell's 64 triangles (closest hit, strict `<`,
// hits in (1e-4, t_cap)). While entries remain, the bound is refreshed as
// the max over live rays of min(best, per-ray scene-exit cap).
//
// What bounds it on the card: the Möller-Trumbore tests, 46 f32
// operations per ray-triangle pair, so it is ALU-bound; on the 1080p map
// a block walks two or three cells and tests one or two of them, and the
// data it reads once (rays 24 B each, 50 MB; the triangle table and the
// shortlists, under 1 MB) take a fraction of the operations' time.
//
// What the simple design does about it: 256 threads per block with 4 rays
// each keep the TPU kernel's block shape, so the block shares one shortlist
// and visits cells in the TPU kernel's order (which decides exact-t ties).
// A visited cell's 64 triangles (9 floats each) are staged in shared
// memory and read as broadcasts; the slab gate is a block-wide vote
// (__syncthreads_or), the bound a block max-reduction. Rays are read and
// the hits written straight from device memory.
//
// Bit parity with the plain torch version
// (rt_kernel.intersect_rays_pallas_reference): compiled with -fmad=false,
// every product and sum rounds on its own in the JAX kernel's expression
// order; min/max propagate NaN as jnp.minimum/maximum do; 1/det and
// 1/d are correctly rounded quotients.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RT_BH 8
#define RT_BW 128
#define RT_THREADS 256
#define RAYS (RT_BH * RT_BW / RT_THREADS)  // 4 rays per thread
#define CELL 64
#define PARKED 1e7f
#define BIG 3e37f

static __device__ __forceinline__ float nmin(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
static __device__ __forceinline__ float nmax(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// block-wide max (NaN-propagating) of one value per thread
static __device__ float block_max(float v, float* s_red) {
    for (int off = 16; off > 0; off >>= 1) v = nmax(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int tid = threadIdx.x;
    __syncthreads();  // s_red may still be read from the last call
    if ((tid & 31) == 0) s_red[tid >> 5] = v;
    __syncthreads();
    float m = s_red[0];
    for (int w = 1; w < RT_THREADS / 32; ++w) m = nmax(m, s_red[w]);
    return m;
}

static __device__ __forceinline__ float safe_inv(float d) {
    return __fdiv_rn(1.0f, fabsf(d) < 1e-20f ? 1e-20f : d);
}

__global__ void __launch_bounds__(RT_THREADS) rt_kernel(
    const float* __restrict__ tab, const float* __restrict__ cbox,
    const float* __restrict__ tnear, const int* __restrict__ slist,
    const float* __restrict__ tcap_row, const float* __restrict__ rays,
    float* __restrict__ t_out, int* __restrict__ idx_out, int ncells, int nbx, int hp, int wp,
    int height, int width) {
    __shared__ float s_tri[CELL * 9];
    __shared__ float s_red[RT_THREADS / 32];

    const int b = blockIdx.x;
    const int by = b / nbx, bx = b % nbx;
    const int tid = threadIdx.x;
    const float* tn_row = tnear + (size_t)b * ncells;
    const int* sl_row = slist + (size_t)b * ncells;
    const size_t plane = (size_t)hp * wp;
    const float tcap = tcap_row[0];

    float ox[RAYS], oy[RAYS], oz[RAYS], dx[RAYS], dy[RAYS], dz[RAYS];
    float ivx[RAYS], ivy[RAYS], ivz[RAYS], tcv[RAYS], best[RAYS];
    int idx[RAYS];
    bool live[RAYS];
    float my_max = 0.0f;
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
        const int r = tid + j * RT_THREADS;
        const size_t o = (size_t)(by * RT_BH + r / RT_BW) * wp + bx * RT_BW + r % RT_BW;
        ox[j] = rays[o];
        oy[j] = rays[o + plane];
        oz[j] = rays[o + 2 * plane];
        dx[j] = rays[o + 3 * plane];
        dy[j] = rays[o + 4 * plane];
        dz[j] = rays[o + 5 * plane];
        live[j] = ox[j] < PARKED;
        ivx[j] = safe_inv(dx[j]);
        ivy[j] = safe_inv(dy[j]);
        ivz[j] = safe_inv(dz[j]);
        // per-ray scene-exit cap: no hit lies beyond the ray's exit from the
        // scene AABB
        float t_exit = nmax((tcap_row[1] - ox[j]) * ivx[j], (tcap_row[4] - ox[j]) * ivx[j]);
        t_exit = nmin(t_exit, nmax((tcap_row[2] - oy[j]) * ivy[j], (tcap_row[5] - oy[j]) * ivy[j]));
        t_exit = nmin(t_exit, nmax((tcap_row[3] - oz[j]) * ivz[j], (tcap_row[6] - oz[j]) * ivz[j]));
        tcv[j] = nmin(tcap, nmax(t_exit, 0.0f) + 1e-3f);
        best[j] = INFINITY;
        idx[j] = -1;
        my_max = nmax(my_max, live[j] ? tcv[j] : 0.0f);
    }
    // dead rays bound the block at 0, so an all-dead block never walks
    float maxt = block_max(my_max, s_red);

    for (int i = 0; i < ncells && tn_row[i] < maxt; ++i) {
        const int c = sl_row[i];
        const float* cb = cbox + 8 * c;
        bool any = false;
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
            const float t0x = (cb[0] - ox[j]) * ivx[j], t1x = (cb[3] - ox[j]) * ivx[j];
            const float t0y = (cb[1] - oy[j]) * ivy[j], t1y = (cb[4] - oy[j]) * ivy[j];
            const float t0z = (cb[2] - oz[j]) * ivz[j], t1z = (cb[5] - oz[j]) * ivz[j];
            const float tn =
                nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmin(t0z, t1z));
            const float tf =
                nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z));
            any |= live[j] && (tf >= nmax(tn, 0.0f)) && (tn < nmin(best[j], tcv[j]));
        }
        if (__syncthreads_or(any)) {
            const float* src = tab + (size_t)c * CELL * 16;
            for (int q = tid; q < CELL * 9; q += RT_THREADS) s_tri[q] = src[(q / 9) * 16 + q % 9];
            __syncthreads();
            for (int k = 0; k < CELL; ++k) {
                const float* T = s_tri + 9 * k;
                const float ax = T[0], ay = T[1], az = T[2];
                const float e1x = T[3], e1y = T[4], e1z = T[5];
                const float e2x = T[6], e2y = T[7], e2z = T[8];
                const int slot = c * CELL + k;
#pragma unroll
                for (int j = 0; j < RAYS; ++j) {
                    const float hx = dy[j] * e2z - dz[j] * e2y;
                    const float hy = dz[j] * e2x - dx[j] * e2z;
                    const float hz = dx[j] * e2y - dy[j] * e2x;
                    const float det = e1x * hx + e1y * hy + e1z * hz;
                    const bool okd = fabsf(det) >= 1e-6f;
                    const float f = okd ? __fdiv_rn(1.0f, det) : 0.0f;
                    const float svx = ox[j] - ax, svy = oy[j] - ay, svz = oz[j] - az;
                    const float uu = f * (svx * hx + svy * hy + svz * hz);
                    bool ok = okd && (uu >= 0.0f) && (uu <= 1.0f);
                    const float qx = svy * e1z - svz * e1y;
                    const float qy = svz * e1x - svx * e1z;
                    const float qz = svx * e1y - svy * e1x;
                    const float vv = f * (dx[j] * qx + dy[j] * qy + dz[j] * qz);
                    ok = ok && (vv >= 0.0f) && (uu + vv <= 1.0f);
                    const float tt = f * (e2x * qx + e2y * qy + e2z * qz);
                    ok = ok && (tt > 1e-4f) && (tt < tcap);
                    if (ok && tt < best[j]) {
                        best[j] = tt;
                        idx[j] = slot;
                    }
                }
            }
            __syncthreads();  // every thread is done with s_tri
        }
        // refresh the early-exit bound while entries remain
        if (tn_row[min(i + 1, ncells - 1)] < BIG) {
            float m = 0.0f;
#pragma unroll
            for (int j = 0; j < RAYS; ++j) m = nmax(m, live[j] ? nmin(best[j], tcv[j]) : 0.0f);
            maxt = block_max(m, s_red);
        }
    }

#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
        const int r = tid + j * RT_THREADS;
        const int gy = by * RT_BH + r / RT_BW, gx = bx * RT_BW + r % RT_BW;
        if (gy < height && gx < width) {
            t_out[(size_t)gy * width + gx] = best[j];
            idx_out[(size_t)gy * width + gx] = idx[j];
        }
    }
}

extern "C" int rx_rt_intersect(const float* tab, const float* cbox, const float* tnear,
                               const int* slist, const float* tcap, const float* rays,
                               float* t, int* idx, int ncells, int nby, int nbx, int height,
                               int width, void* stream) {
    rt_kernel<<<nby * nbx, RT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        tab, cbox, tnear, slist, tcap, rays, t, idx, ncells, nbx, nby * RT_BH, nbx * RT_BW,
        height, width);
    return (int)cudaGetLastError();
}

// Visibility-only tile kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in rusterix_tpu/ops/visibility_pallas.py
// (launched by `visibility_pass_pallas` there): for one 64x128 screen tile
// it walks every super-chunk, and every chunk, whose merged integer box
// meets the tile and keeps per pixel the closest covering candidate (max
// 1/z with a strict `>` from 1.0, no early stop). Outputs z = 1/best and
// the winning sorted slot (-1 where none covers), for the reflection
// G-buffer that needs them before shading.
//
// What bounds it on the card: like the megakernel's stage 1, the edge
// tests (four plane evaluations per candidate per pixel) make it
// ALU-bound; it reads the candidate planes (a few hundred KB, L2-resident)
// and writes 8 bytes per pixel.
//
// What the simple design does about it: it is the megakernel's scan
// (visibility.cuh) without the early stop and the shading: one block of
// 512 threads per tile, each thread one column and 16 rows, the super's
// planes staged in shared memory, block-uniform box gating. The ragged
// edge of the frame is scanned as padding and masked on the write.
//
// Bit parity with the plain torch version
// (visibility_pallas.visibility_pass_pallas_reference): compiled with
// -fmad=false, the planes evaluate as (a*x + c) + b*y with each op rounded
// on its own, and z = 1/best is the correctly rounded quotient.

#include <cuda_runtime.h>

#include "visibility.cuh"

__global__ void __launch_bounds__(THREADS) visibility_kernel(
    const float* __restrict__ planes, const int* __restrict__ sbox,
    const int* __restrict__ cbox, float* __restrict__ z, int* __restrict__ idx_out, int ns,
    int height, int width) {
    __shared__ float s_planes[GROUP * 12];

    const int x0 = blockIdx.x * TILE_W;
    const int y0 = blockIdx.y * TILE_H;
    const int tid = threadIdx.x;

    float xs, ys[PPT], best[PPT];
    int idx[PPT];
    tile_pixels(x0, y0, tid, xs, ys, best, idx);

    for (int s = 0; s < ns; ++s) {
        if (!box_meets_tile(sbox + 4 * s, x0, y0)) continue;
        stage_super(s_planes, planes, s, tid);
        __syncthreads();
        scan_super(s_planes, cbox, s, x0, y0, xs, ys, best, idx);
        __syncthreads();  // every thread is done with s_planes
    }

    const int gx = x0 + tid % TILE_W;
    if (gx >= width) return;
#pragma unroll
    for (int r = 0; r < PPT; ++r) {
        const int gy = y0 + tid / TILE_W + r * ROWS_PER_STEP;
        if (gy < height) {
            const size_t o = (size_t)gy * width + gx;
            z[o] = __fdiv_rn(1.0f, best[r]);
            idx_out[o] = idx[r];
        }
    }
}

extern "C" int rx_visibility(const float* planes, const int* sbox, const int* cbox, float* z,
                             int* idx, int ns, int height, int width, void* stream) {
    dim3 grid((width + TILE_W - 1) / TILE_W, (height + TILE_H - 1) / TILE_H);
    visibility_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        planes, sbox, cbox, z, idx, ns, height, width);
    return (int)cudaGetLastError();
}

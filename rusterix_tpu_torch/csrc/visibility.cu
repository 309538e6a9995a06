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
// What bounds it on the card: the edge tests (four plane evaluations per
// candidate per pixel) make it ALU-bound, but the work is very uneven: on
// the 1080p map a quarter of the tiles hold all the candidates and one
// tile 5% of them, so with one block per tile the kernel's time was the
// heaviest tile's, not the card's rate.
//
// What the design does about it: it is the megakernel's scan
// (visibility.cuh) without the early stop and the shading. Without an early
// stop the pixels of a tile do not depend on each other, so each tile is
// cut into 8 slices of 8 rows and every slice is a block of its own (256
// threads, 4 pixels each, 64 registers or fewer, several blocks resident on
// an SM): a heavy tile spreads over eight SMs. The gates stay the tile's
// (super and chunk boxes against the 64x128 tile), so the tests are the
// same set. Supers arrive through the ring of two bulk asynchronous copies.
// The ragged edge of the frame is scanned as padding and masked on the
// write.
//
// Row-sharded frames: with a row offset y_off the outputs are the frame's
// rows [y_off, y_off + height). The pixel centres and the tiles' box gates
// take the frame's rows (tile row + y_off), the writes the slab's.
//
// Bit parity with the plain torch version
// (visibility_pallas.visibility_pass_pallas_reference): compiled with
// -fmad=false, the planes evaluate as (a*x + c) + b*y with each op rounded
// on its own, and z = 1/best is the correctly rounded quotient.

#include <cuda_runtime.h>

#include "visibility.cuh"

#define VIS_SLICES 8
#define VIS_PPT SLICE_PPT(VIS_SLICES)

__global__ void __launch_bounds__(THREADS, 4) visibility_kernel(
    const float* __restrict__ planes, const int* __restrict__ sbox,
    const int* __restrict__ cbox, float* __restrict__ z, int* __restrict__ idx_out, int ns,
    int height, int width, int y_off) {
    extern __shared__ __align__(16) unsigned char vis_smem[];
    ScanRing* ring = reinterpret_cast<ScanRing*>(vis_smem);
    uint32_t* meet = reinterpret_cast<uint32_t*>(vis_smem + sizeof(ScanRing));

    const int x0 = blockIdx.x * TILE_W;
    const int ty = (blockIdx.y / VIS_SLICES) * TILE_H;  // the tile's first row in the slab
    const int y0 = ty + y_off;                          // ... and in the frame
    const int slice = blockIdx.y % VIS_SLICES;
    const int tid = threadIdx.x;

    float xs, ys[VIS_PPT], best[VIS_PPT];
    int idx[VIS_PPT];
    slice_pixels<VIS_PPT>(x0, y0, slice, xs, ys, best, idx);

    supers_meeting_tile(meet, sbox, ns, x0, y0);
    if (tid == 0) {
        mbar_init(&ring->mbar[0], 1);
        mbar_init(&ring->mbar[1], 1);
        mbar_init_fence();
    }
    __syncthreads();

    int cur = next_super(meet, 0, ns);
    if (cur < ns && tid == 0) ring_start(ring, 0, planes, cbox, cur);
    for (int k = 0; cur < ns; ++k) {
        const int nxt = next_super(meet, cur + 1, ns);
        // slot (k+1)&1 was scanned in iteration k-1; the barrier that ended
        // it lies behind every thread
        if (nxt < ns && tid == 0) ring_start(ring, (k + 1) & 1, planes, cbox, nxt);
        mbar_wait(&ring->mbar[k & 1], (k >> 1) & 1);
        scan_super<VIS_PPT>(ring->planes[k & 1], ring->cbox[k & 1], cur, x0, y0, xs, ys, best,
                            idx);
        __syncthreads();  // every thread is done with slot k&1
        cur = nxt;
    }

    const int gx = x0 + tid % TILE_W;
    if (gx >= width) return;
#pragma unroll
    for (int r = 0; r < VIS_PPT; ++r) {
        const int gy = ty + slice_row<VIS_PPT>(slice, r);
        if (gy < height) {
            const size_t o = (size_t)gy * width + gx;
            z[o] = __fdiv_rn(1.0f, best[r]);
            idx_out[o] = idx[r];
        }
    }
}

extern "C" int rx_visibility_resources(int ns, int* out) {
    return kernel_resources(visibility_kernel, THREADS, sizeof(ScanRing) + 4 * ((ns + 31) / 32),
                            out);
}

extern "C" int rx_visibility(const float* planes, const int* sbox, const int* cbox, float* z,
                             int* idx, int ns, int height, int width, int y_off,
                             void* stream) {
    dim3 grid((width + TILE_W - 1) / TILE_W, ((height + TILE_H - 1) / TILE_H) * VIS_SLICES);
    const size_t smem = sizeof(ScanRing) + 4 * ((ns + 31) / 32);
    cudaError_t err = cudaFuncSetAttribute(visibility_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    visibility_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        planes, sbox, cbox, z, idx, ns, height, width, y_off);
    return (int)cudaGetLastError();
}

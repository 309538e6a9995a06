// The tile visibility scan shared by the megakernel (megakernel.cu, B1)
// and the visibility-only kernel (visibility.cu, B2).
//
// One block of THREADS threads owns one TILE_H x TILE_W screen tile; each
// thread owns one column of the tile and PPT of its rows. Candidates come
// in Morton-sorted super-chunks of GROUP slots (SUPER chunks of CHUNK),
// with merged integer boxes per super and per chunk. A super that meets
// the tile has its GROUP plane rows staged in shared memory, and each of
// its chunks that meets the tile is scanned: per candidate the three edge
// planes and the 1/z plane evaluate as (a*x + c) + b*y, each op rounded on
// its own, and a covering candidate wins with a strict 1/z > best.

#pragma once

#include <cuda_runtime.h>

#define TILE_H 64
#define TILE_W 128
#define CHUNK 4
#define SUPER 32
#define GROUP (CHUNK * SUPER)
#define THREADS 512
#define ROWS_PER_STEP (THREADS / TILE_W)   // 4 rows of the tile per step
#define PPT (TILE_H / ROWS_PER_STEP)        // 16 pixels per thread

// does the merged integer box b = (x0, y0, x1, y1) meet the tile at (x0, y0)?
static __device__ __forceinline__ bool box_meets_tile(const int* b, int x0, int y0) {
    return b[0] < x0 + TILE_W && b[2] > x0 && b[1] < y0 + TILE_H && b[3] > y0;
}

// this thread's pixel centres and the scan's start: best 1/z = 1.0, no
// winner. Padded pixels past the frame take part in the scan exactly as in
// the TPU kernels' padded tiles.
static __device__ __forceinline__ void tile_pixels(int x0, int y0, int tid, float& xs,
                                                   float ys[PPT], float best[PPT],
                                                   int idx[PPT]) {
    const int lx = tid % TILE_W;
    const int ly = tid / TILE_W;
    xs = (float)lx + ((float)x0 + 0.5f);
#pragma unroll
    for (int r = 0; r < PPT; ++r) {
        ys[r] = (float)(ly + r * ROWS_PER_STEP) + ((float)y0 + 0.5f);
        best[r] = 1.0f;
        idx[r] = -1;
    }
}

// stage super s's GROUP plane rows in shared memory (the caller syncs)
static __device__ __forceinline__ void stage_super(float* s_planes, const float* planes, int s,
                                                   int tid) {
    const float* src = planes + (size_t)s * GROUP * 12;
    for (int i = tid; i < GROUP * 12; i += THREADS) s_planes[i] = src[i];
}

// scan the staged super s's chunks that meet the tile
static __device__ __forceinline__ void scan_super(const float* s_planes, const int* cbox, int s,
                                                  int x0, int y0, float xs, const float ys[PPT],
                                                  float best[PPT], int idx[PPT]) {
    for (int c = 0; c < SUPER; ++c) {
        if (!box_meets_tile(cbox + 4 * (s * SUPER + c), x0, y0)) continue;
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
}

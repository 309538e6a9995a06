// The tile visibility scan shared by the megakernel (megakernel.cu, B1)
// and the visibility-only kernel (visibility.cu, B2).
//
// The unit of decision stays the TILE_H x TILE_W screen tile of the TPU
// kernels: a super-chunk of GROUP candidate slots (SUPER chunks of CHUNK)
// is scanned when its merged integer box meets the tile, a chunk when its
// box meets the tile, so the set of (pixel, candidate) tests is the TPU
// kernels' and the plain versions'. The unit of work is smaller: a tile is
// cut into SLICES horizontal slices of TILE_H / SLICES rows, one block of
// THREADS threads each, so that a heavy tile spreads over several SMs. A
// thread owns one column of its slice and PPT of its rows.
//
// A super's GROUP plane rows (6 KB) and its SUPER chunk boxes (512 B) are
// contiguous in device memory. One thread copies them with a bulk
// asynchronous copy (cp.async.bulk, completion on an mbarrier) into a ring
// of two buffers, so the next super that meets the tile is in flight while
// this one is scanned. Per candidate the three edge planes and the 1/z
// plane evaluate as (a*x + c) + b*y, each op rounded on its own, and a
// covering candidate wins with a strict 1/z > best.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

#define TILE_H 64
#define TILE_W 128
#define CHUNK 4
#define SUPER 32
#define GROUP (CHUNK * SUPER)
#define THREADS 256
#define ROWS_PER_STEP (THREADS / TILE_W)  // 2 rows of the slice per step
#define PLANE_FLOATS (GROUP * 12)
#define PLANE_BYTES (PLANE_FLOATS * 4)
#define CBOX_INTS (SUPER * 4)
#define CBOX_BYTES (CBOX_INTS * 4)

// rows of a slice and pixels per thread when a tile is cut into `slices`
#define SLICE_ROWS(slices) (TILE_H / (slices))
#define SLICE_PPT(slices) (SLICE_ROWS(slices) / ROWS_PER_STEP)

// the staging ring in shared memory (16-byte aligned for the bulk copies)
struct __align__(16) ScanRing {
    float planes[2][PLANE_FLOATS];
    int cbox[2][CBOX_INTS];
    unsigned long long mbar[2];
};

// ---- mbarrier + bulk copy (PTX) ----

static __device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}
static __device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
static __device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}
static __device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
    } while (!done);
}
static __device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                                 unsigned long long* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
            "r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// one thread: start the copy of super s's planes and chunk boxes into ring
// slot `buf`. Every thread of the block has finished reading that slot (a
// block barrier lies between its last scan and this call).
static __device__ __forceinline__ void ring_start(ScanRing* ring, int buf, const float* planes,
                                                  const int* cbox, int s) {
    mbar_expect_tx(&ring->mbar[buf], PLANE_BYTES + CBOX_BYTES);
    bulk_copy(ring->planes[buf], planes + (size_t)s * PLANE_FLOATS, PLANE_BYTES,
              &ring->mbar[buf]);
    bulk_copy(ring->cbox[buf], cbox + (size_t)s * CBOX_INTS, CBOX_BYTES, &ring->mbar[buf]);
}

// does the merged integer box b = (x0, y0, x1, y1) meet the tile at (x0, y0)?
static __device__ __forceinline__ bool box_meets_tile(const int* b, int x0, int y0) {
    return b[0] < x0 + TILE_W && b[2] > x0 && b[1] < y0 + TILE_H && b[3] > y0;
}

// one bit per super: does its box meet the tile? (all threads; the caller
// syncs). `meet` holds (ns + 31) / 32 words.
static __device__ __forceinline__ void supers_meeting_tile(uint32_t* meet, const int* sbox,
                                                           int ns, int x0, int y0) {
    const int tid = threadIdx.x;
    for (int base = 0; base < ns; base += THREADS) {
        const int s = base + tid;
        bool m = false;
        if (s < ns) {
            const int4 b = __ldg(reinterpret_cast<const int4*>(sbox) + s);
            m = b.x < x0 + TILE_W && b.z > x0 && b.y < y0 + TILE_H && b.w > y0;
        }
        const uint32_t word = __ballot_sync(0xffffffffu, m);
        if ((tid & 31) == 0 && base + tid < ns) meet[(base + tid) >> 5] = word;
    }
}

// the first super >= s whose bit is set, or ns
static __device__ __forceinline__ int next_super(const uint32_t* meet, int s, int ns) {
    while (s < ns) {
        const uint32_t w = meet[s >> 5] >> (s & 31);
        if (w) return min(s + __ffs(w) - 1, ns);
        s = (s | 31) + 1;
    }
    return ns;
}

// (x0, y0) below is a tile's corner in the frame's screen coordinates: under
// row sharding y0 is the slab's row offset plus the tile's row in the slab.

// this thread's pixel centres in slice `slice` of the tile at (x0, y0) and
// the scan's start: best 1/z = 1.0, no winner. Padded pixels past the frame
// take part in the scan exactly as in the TPU kernels' padded tiles.
template <int PPT>
static __device__ __forceinline__ void slice_pixels(int x0, int y0, int slice, float& xs,
                                                    float ys[PPT], float best[PPT],
                                                    int idx[PPT]) {
    const int lx = threadIdx.x % TILE_W;
    const int ly = slice * (PPT * ROWS_PER_STEP) + threadIdx.x / TILE_W;
    xs = (float)lx + ((float)x0 + 0.5f);
#pragma unroll
    for (int r = 0; r < PPT; ++r) {
        ys[r] = (float)(ly + r * ROWS_PER_STEP) + ((float)y0 + 0.5f);
        best[r] = 1.0f;
        idx[r] = -1;
    }
}

// row of the tile that pixel r of this thread lies on
template <int PPT>
static __device__ __forceinline__ int slice_row(int slice, int r) {
    return slice * (PPT * ROWS_PER_STEP) + threadIdx.x / TILE_W + r * ROWS_PER_STEP;
}

// scan the staged super s: its chunks whose box meets the tile (x0, y0)
template <int PPT>
static __device__ __forceinline__ void scan_super(const float* s_planes, const int* s_cbox, int s,
                                                  int x0, int y0, float xs, const float ys[PPT],
                                                  float best[PPT], int idx[PPT]) {
    for (int c = 0; c < SUPER; ++c) {
        if (!box_meets_tile(s_cbox + 4 * c, x0, y0)) continue;
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
            const float4* p4 = reinterpret_cast<const float4*>(s_planes + (c * CHUNK + k) * 12);
            const float4 pa = p4[0], pb = p4[1], pc = p4[2];
            const int slot = (s * SUPER + c) * CHUNK + k;
            // plane i is (a, b, c) = floats 3i..3i+2; (a*xs + c) + b*ys,
            // each op rounded on its own
            const float r0 = __fadd_rn(__fmul_rn(pa.x, xs), pa.z);
            const float r1 = __fadd_rn(__fmul_rn(pa.w, xs), pb.y);
            const float r2 = __fadd_rn(__fmul_rn(pb.z, xs), pc.x);
            const float r3 = __fadd_rn(__fmul_rn(pc.y, xs), pc.w);
#pragma unroll
            for (int r = 0; r < PPT; ++r) {
                const float e0 = __fadd_rn(r0, __fmul_rn(pa.y, ys[r]));
                const float e1 = __fadd_rn(r1, __fmul_rn(pb.x, ys[r]));
                const float e2 = __fadd_rn(r2, __fmul_rn(pb.w, ys[r]));
                const float invz = __fadd_rn(r3, __fmul_rn(pc.z, ys[r]));
                if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && invz > best[r]) {
                    best[r] = invz;
                    idx[r] = slot;
                }
            }
        }
    }
}

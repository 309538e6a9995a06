// Secondary-ray closest hit for Hopper (sm_90a): the shortlist preparation
// and the walk.
//
// `rt_kernel` replaces the TPU kernel `_rt_kernel` in
// rusterix_tpu/ops/rt_kernel.py (launched by `intersect_rays_pallas`
// there): one block per 8x128 ray block walks the block's distance-ordered
// shortlist of 64-triangle cells while the next entry's t lower bound is
// below the block's bound. Per visited cell every ray slab-tests the cell
// box; when any live ray enters closer than min(best, its scene-exit cap),
// the block runs Möller-Trumbore of all its rays against the cell's 64
// triangles (closest hit, strict `<`, hits in (1e-4, t_cap)). While entries
// remain, the bound is refreshed as the max over live rays of min(best,
// per-ray scene-exit cap).
//
// `rt_prepare_kernel` replaces the XLA code around that kernel
// (rusterix_tpu/ops/rt_kernel.py, `intersect_rays_pallas`: the per-block
// origin and direction boxes, the per-(block, cell) keys and their stable
// sort): one block per ray block reads its 1024 rays once, reduces the
// twelve box values over live rays (NaN values skipped), computes each
// cell's key (the gap between the origin box and the cell box, _BIG for
// cells out of range, dead or behind every ray) and ranks the keys.
//
// What bounded the first design: the row's time was the preparation, some
// sixty small torch launches (twelve masked reductions over 2*10^6-element
// fields, forty elementwise ops on the keys, a segmented sort) around a
// 0.85 ms kernel; the kernel itself passed five block barriers per visited
// cell, staged triangles with strided scalar loads and nothing in flight,
// and at 97 registers kept two blocks of 256 threads on an SM.
//
// What this design does about it:
// - The preparation is one launch that reads the rays once (50 MB at 1080p)
//   and never materialises a padded copy: both kernels read the six (H, W)
//   fields directly and treat lanes past the frame as parked rays. Keys are
//   (f32 bits << 32 | cell) in shared memory; keys are non-negative floats,
//   so the u64 order is the key order with ties in cell order, and a rank
//   sort (count the smaller keys) is stable by construction. The keys are
//   dynamic shared memory, 8 bytes a cell, so a scene may have as many cells
//   as a block's shared memory holds (RT_MAX_CELLS).
// - The walk's time is its Moeller-Trumbore instructions (unfused, so some
//   80 a pair), and what moved it was not the barriers or the copies but
//   the rays a thread holds: with four rays a thread (256 threads a block,
//   88 registers) the kernel took the first design's time whatever else
//   changed; with one ray a thread (1024 threads a block, one block an SM,
//   64 registers) it takes a quarter less. With one ray the u test below is
//   a branch a whole warp can skip. Sharing a ray block between 2 or 4
//   blocks of a thread block cluster (the decisions combined through
//   distributed shared memory) was measured too and gained nothing over
//   that: the walk is not short of parallel blocks.
// - The walk passes one block barrier per visited cell and a second one
//   only when the cell is tested: the refresh of the bound and the slab
//   vote for the NEXT entry share one round (the vote rides on the barrier,
//   __syncthreads_or; the max goes through one shared slot per warp, slots
//   alternating so no second barrier guards them). The next entry's 64
//   triangles are copied as whole 16-float rows with cp.async into the
//   other half of a two-cell ring while this cell is tested. The vote
//   stays the block's: a warp-level gate would skip pairs the TPU kernel
//   tests, and a ray the slab test rejects can still hit a triangle on the
//   box's face.
// - Within a pair the u test rejects most triangles; v and t are computed
//   only for rays that pass it (the result is the same: a failed u test
//   already decides the pair). 1/det is __frcp_rn, the correctly rounded
//   reciprocal, the same value as the IEEE quotient 1/det.
//
// - The rank sort is O(cells^2) a block, so above rt_kernel.PREPARE_MAX_CELLS
//   cells `rt_prepare_cluster_kernel` takes the scene: a thread block cluster
//   of 1 to 8 blocks a ray block (1 while a block holds the row), the row's
//   keys and cells in the cluster's shared memory (16 bytes a cell: two
//   buffers of a u32 key and a u32 cell), sorted by a stable LSD radix sort
//   on the keys' upper 32 bits, 8 bits a pass. Its first design wrote the
//   keys to a global scratch row and sorted them by a bitonic network: some
//   eight passes of the row through device memory and O(n log^2 n) work, at
//   2.3 % of its bound on 1080p rays over 28,700 cells and slower than
//   torch.sort of the same keys. A pass of the radix sort costs O(n) in
//   shared memory; its scatter lands in whichever block of the cluster holds
//   the key's position (distributed shared memory), so after the last pass
//   every block holds its span of the sorted row and writes it once: no
//   global scratch and no merge of sorted runs. A byte in which no key of
//   the row differs is not sorted at all (a row of parked rays, whose keys
//   are all BIG, or a row whose cells all lie at gap 0). It reads the rays
//   once a block (the cluster's blocks read them from L2) and writes each
//   output once; what is left of its time is the passes' instructions and
//   the cluster barriers between them.
// - Above rt_kernel's CLUSTER_MAX_CELLS the global route takes the scene:
//   it sorts a row through device memory, so no row is too long for it
//   (the cluster route holds 8 * RT_SPAN_MAX cells), and above 28,672 cells
//   it is the faster of the two on 1080p rays. Its first design gave one block
//   of 256 threads a whole row of u64 (key << 32 | cell) keys padded to a
//   power of two and sorted it by a bitonic network: O(n log^2 n), some 22
//   traversals of the row at 32,768 keys and 44 at 131,072, each behind a
//   block barrier, at 2.3 % of its bound and slower than torch.sort of the
//   same keys. This design is an LSD radix sort on the keys' 32 bits with
//   the cell as payload (stable, so ties stay in cell order), spread over
//   many blocks a row: `rt_prepare_large_boxes` (a block a ray block: the
//   boxes, and the row's counters zeroed), `rt_prepare_large_count` (blocks
//   of LG_COUNT_TILE cells: the keys computed from the boxes and the cell
//   boxes, which stay in L2; each byte's digit counts and the AND/OR of the
//   keys added to the row's, nothing written per key) and four launches of
//   `rt_prepare_large_kernel`, one a byte. A byte in which no key of the
//   row differs is skipped; a row whose keys are all equal is written once
//   in cell order. In a pass every block takes a tile of LG_TILE pairs in
//   the row's current order (its first pass recomputes the keys instead of
//   reading them), ranks them stably by the cluster route's ballots, finds
//   how many of each digit the row's earlier tiles hold by decoupled
//   look-back (Onesweep, Adinets & Merrill 2022: each tile publishes its
//   digit counts, then its inclusive prefix, in one word a digit), and
//   writes its pairs through shared memory in digit runs, 8 bytes a pair.
//   The passes alternate between a scratch of 8 bytes a (ray block, cell)
//   and the outputs themselves, so that the last one writes tnear and
//   slist: at four passes some 56 bytes a pair move, against the first
//   design's hundreds. The passes still run at about half the memory rate;
//   what was measured against that (tools/prep_forms_torch.py, PERF.md):
//   three blocks a SM rather than two took some 4 % off (kept), while a
//   look-back reading eight tiles at once, `__match_any_sync` in place of
//   the ballots, tiles of 2,048 or 8,192 pairs and a count of eight rows a
//   block (each cell box read once for them) were as fast or slower.
// Every route orders the keys as u64 (key bits << 32 | cell) would, so every
// route gives the same bits.
//
// Bit parity with the plain torch versions (rt_kernel.rt_prepare and
// rt_kernel.intersect_rays_pallas_reference): compiled with -fmad=false,
// every product and sum rounds on its own in the JAX code's expression
// order; min/max propagate NaN as jnp.minimum/maximum do; sqrt, 1/det and
// 1/d are correctly rounded.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"  // kernel_resources

// the tuning knobs (ops/rt_kernel.py rt_knobs passes other values as -D
// flags into a build directory of their own)
#ifndef RT_BH
#define RT_BH 8
#endif
#ifndef RT_BW
#define RT_BW 128
#endif
#ifndef RT_CELL
#define RT_CELL 64
#endif
#define RT_THREADS 256                      // the preparation: 4 rays per thread
#define RT_WARPS (RT_THREADS / 32)
#define WALK_THREADS (RT_BH * RT_BW)        // the walk: one ray per thread
#define WALK_WARPS (WALK_THREADS / 32)
#define CELL RT_CELL
#define CELL_FLOATS (CELL * 16)
#define RT_MAX_CELLS 28672                  // 224 KB of keys in a block's 227 KB
#define PARKED 1e7f
#define BIG 3e37f

static __device__ __forceinline__ float nmin(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
static __device__ __forceinline__ float nmax(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

static __device__ __forceinline__ float safe_inv(float d) {
    return __fdiv_rn(1.0f, fabsf(d) < 1e-20f ? 1e-20f : d);
}

struct RayFields {
    const float* f[6];  // ox oy oz dx dy dz, each (height, width)
};

// ray r (0..1023) of block (by, bx): its frame offset, or -1 past the frame
static __device__ __forceinline__ long long ray_offset(int by, int bx, int r, int height,
                                                       int width) {
    const int gy = by * RT_BH + r / RT_BW, gx = bx * RT_BW + r % RT_BW;
    return (gy < height && gx < width) ? (long long)gy * width + gx : -1;
}

// ------------------------------------------------------------ preparation

// The block's origin and direction boxes over its live rays into s_box[12]
// (and boxes[b] unless boxes is null): [o min xyz | o max xyz | d min xyz |
// d max xyz]; a dead ray, a lane past the frame or a NaN value contributes
// the neutral +-BIG. THREADS threads, s_part[THREADS / 32]. Ends with a
// barrier.
template <int THREADS>
static __device__ __forceinline__ void block_boxes(const RayFields& rays, float (*s_part)[12],
                                                   float* s_box, float* __restrict__ boxes,
                                                   int b, int nbx, int height, int width) {
    const int by = b / nbx, bx = b % nbx;
    const int tid = threadIdx.x;
    float v[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) v[i] = (i % 6 < 3) ? INFINITY : -INFINITY;
#pragma unroll
    for (int j = 0; j < RT_BH * RT_BW / THREADS; ++j) {
        const long long o = ray_offset(by, bx, tid + j * THREADS, height, width);
        const float ox = o >= 0 ? rays.f[0][o] : 1e8f;
        const bool live = ox < PARKED;
#pragma unroll
        for (int kf = 0; kf < 6; ++kf) {
            float x;
            if (kf == 0) x = ox;
            else if (kf < 3) x = o >= 0 ? rays.f[kf][o] : 1e8f;
            else x = o >= 0 ? rays.f[kf][o] : 0.0f;
            const bool use = live && (x == x);
            const int lo = kf < 3 ? kf : kf + 3, hi = lo + 3;
            v[lo] = fminf(v[lo], use ? x : BIG);
            v[hi] = fmaxf(v[hi], use ? x : -BIG);
        }
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) {
        float x = v[i];
        for (int off = 16; off > 0; off >>= 1) {
            const float y = __shfl_xor_sync(0xffffffffu, x, off);
            x = (i % 6 < 3) ? fminf(x, y) : fmaxf(x, y);
        }
        if ((tid & 31) == 0) s_part[tid >> 5][i] = x;
    }
    __syncthreads();
    if (tid < 12) {
        float x = s_part[0][tid];
        for (int w = 1; w < THREADS / 32; ++w)
            x = (tid % 6 < 3) ? fminf(x, s_part[w][tid]) : fmaxf(x, s_part[w][tid]);
        s_box[tid] = x;
        if (boxes) boxes[(size_t)b * 12 + tid] = x;
    }
    __syncthreads();
}

// Cell c's key for the block whose boxes are s_box: (f32 bits of the t lower
// bound << 32 | c); the bound is the gap between the origin box and the cell
// box, BIG for a cell out of range, dead or behind every ray.
static __device__ __forceinline__ unsigned long long cell_key(const float* __restrict__ cbox,
                                                              const float* s_box, int c,
                                                              float t_cap) {
    // the cell's box [x0 y0 z0 x1 | y1 z1 0 0] in two 16-byte loads
    const float4* q = reinterpret_cast<const float4*>(cbox + 8 * c);
    const float4 lo = q[0], hi = q[1];
    const float cb[6] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y};
    float g2 = 0.0f;
    bool reach = true;
#pragma unroll
    for (int kf = 0; kf < 3; ++kf) {
        const float c0 = cb[kf], c1 = cb[3 + kf];
        const float ob0 = s_box[kf], ob1 = s_box[3 + kf];
        const float db0 = s_box[6 + kf], db1 = s_box[9 + kf];
        // the gap between origin box and cell box along this axis
        const float g = nmax(nmax(c0 - ob1, ob0 - c1), 0.0f);
        g2 = kf == 0 ? g * g : g2 + g * g;
        // a cell strictly on the + side of every origin is out of reach
        // when no live ray points +, and mirrored
        const bool pos_side = c0 > ob1, neg_side = c1 < ob0;
        reach = reach && !((pos_side && db1 <= 0.0f) || (neg_side && db0 >= 0.0f));
    }
    const float dist = __fsqrt_rn(g2);
    const bool cell_alive = cb[0] <= cb[3];
    const float key = (cell_alive && reach && dist < t_cap) ? dist : BIG;
    return ((unsigned long long)__float_as_uint(key) << 32) | (unsigned)c;
}

__global__ void __launch_bounds__(RT_THREADS) rt_prepare_kernel(
    const RayFields rays, const float* __restrict__ cbox, float t_cap,
    float* __restrict__ boxes, float* __restrict__ tnear, int* __restrict__ slist, int ncells,
    int nbx, int height, int width) {
    __shared__ float s_part[RT_WARPS][12];
    __shared__ float s_box[12];
    extern __shared__ unsigned long long s_key[];  // ncells (key, cell) pairs

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    block_boxes<RT_THREADS>(rays, s_part, s_box, boxes, b, nbx, height, width);

    for (int c = tid; c < ncells; c += RT_THREADS) s_key[c] = cell_key(cbox, s_box, c, t_cap);
    __syncthreads();

    // ---- stable rank sort: position = number of smaller (key, cell) pairs ----
    for (int c = tid; c < ncells; c += RT_THREADS) {
        const unsigned long long mine = s_key[c];
        int rank = 0;
        for (int j = 0; j < ncells; ++j) rank += s_key[j] < mine;
        tnear[(size_t)b * ncells + rank] = __uint_as_float((unsigned)(mine >> 32));
        slist[(size_t)b * ncells + rank] = c;
    }
}

extern "C" int rx_rt_prepare(const float* ox, const float* oy, const float* oz, const float* dx,
                             const float* dy, const float* dz, const float* cbox, float t_cap,
                             float* boxes, float* tnear, int* slist, int ncells, int nby,
                             int nbx, int height, int width, void* stream) {
    if (ncells > RT_MAX_CELLS) return (int)cudaErrorInvalidValue;
    RayFields rays;
    rays.f[0] = ox;
    rays.f[1] = oy;
    rays.f[2] = oz;
    rays.f[3] = dx;
    rays.f[4] = dy;
    rays.f[5] = dz;
    const size_t smem = sizeof(unsigned long long) * (size_t)ncells;
    cudaError_t err = cudaFuncSetAttribute(rt_prepare_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    rt_prepare_kernel<<<nby * nbx, RT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        rays, cbox, t_cap, boxes, tnear, slist, ncells, nbx, height, width);
    return (int)cudaGetLastError();
}

// ------------------------------------------------ the cluster preparation

#define CL_THREADS 512
#define CL_WARPS (CL_THREADS / 32)
#define RADIX_BITS 8
#define RADIX (1 << RADIX_BITS)
#define RT_SPAN_MAX 13312  // cells a block of the cluster route holds, 16 bytes each

// What a block of the cluster route keeps besides its keys (static shared
// memory; rt_kernel.CLUSTER_SMEM_STATIC is its size).
struct ClusterShared {
    unsigned hist[CL_WARPS][RADIX];  // each warp's digit counts, then their prefix over warps
    unsigned tot[RADIX];             // the block's digit counts, read by the cluster
    unsigned base[RADIX];            // where the block's first key of each digit goes
    unsigned wsum[RADIX / 32];
    unsigned mask[2];                // AND and OR of the block's keys, read by the cluster
    float part[CL_WARPS][12];
    float box[12];
};

// the lanes of this warp among `active` whose digit equals this lane's
static __device__ __forceinline__ unsigned digit_peers(unsigned d, bool active) {
    unsigned peers = __ballot_sync(0xffffffffu, active);
#pragma unroll
    for (int bit = 0; bit < RADIX_BITS; ++bit) {
        const bool set = (d >> bit) & 1u;
        const unsigned m = __ballot_sync(0xffffffffu, set);
        peers &= set ? m : ~m;
    }
    return peers;
}

// floor(v / x) by m = ceil(2^32 / x): exact for v < 2^17, x <= RT_SPAN_MAX
static __device__ __forceinline__ unsigned div_by(unsigned v, unsigned long long m) {
    return (unsigned)(((unsigned long long)v * m) >> 32);
}

// a barrier of the cluster, which is the block itself when cl is 1
static __device__ __forceinline__ void cluster_sync(int cl) {
    if (cl == 1) {
        __syncthreads();
    } else {
        cluster_arrive();
        cluster_wait();
    }
}

// The preparation of scenes whose keys outgrow one block's shared memory
// but fit a cluster's: a thread block cluster of `cl` blocks a ray block,
// block `rank` holding `span` consecutive positions of the row as (key,
// cell) pairs. Each block computes the boxes itself and the keys of cells
// [rank * span, + span), then the cluster sorts the row by an LSD radix
// sort on the keys' upper 32 bits (the f32 distance, never negative, so its
// bits order as its values), 8 bits a pass. A pass counts each warp's
// digits (shared atomics: order does not matter to a count), places the
// block's keys after the smaller digits of the whole row and after the
// same digit in earlier blocks, warps, rounds of 32 and lanes (ballots:
// stable, so ties stay in cell order, the u64 order of the other routes),
// and stores each pair where its position falls, in this block's shared
// memory or another's. A byte in which no key of the row differs is the
// identity and is skipped. After the last pass each block holds its span
// of the sorted row and writes it once, coalesced.
__global__ void __launch_bounds__(CL_THREADS, 4) rt_prepare_cluster_kernel(
    const RayFields rays, const float* __restrict__ cbox, float t_cap,
    float* __restrict__ boxes, float* __restrict__ tnear, int* __restrict__ slist, int ncells,
    int cl, int span, int nbx, int height, int width) {
    __shared__ ClusterShared s;
    extern __shared__ uint2 s_pair[];  // two buffers of span (key, cell) pairs

    const int b = blockIdx.x / cl, rank = blockIdx.x % cl;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int first = rank * span;
    const int cnt = max(0, min(span, ncells - first));
    const unsigned lanes_below = (1u << lane) - 1u;
    // warp w takes positions [w * per, (w + 1) * per) of its block
    const int per = (cnt + CL_WARPS - 1) / CL_WARPS;
    const int lo = min(cnt, warp * per), hi = min(cnt, lo + per);
    const unsigned long long span_m = (0x100000000ull + span - 1) / span;
    if (tid == 0) {
        s.mask[0] = ~0u;
        s.mask[1] = 0u;
    }
    block_boxes<CL_THREADS>(rays, s.part, s.box, rank == 0 ? boxes : nullptr, b, nbx, height,
                            width);

    unsigned all = ~0u, any = 0u;
    for (int i = tid; i < cnt; i += CL_THREADS) {
        const unsigned k = (unsigned)(cell_key(cbox, s.box, first + i, t_cap) >> 32);
        s_pair[i] = make_uint2(k, first + i);
        all &= k;
        any |= k;
    }
    all = __reduce_and_sync(0xffffffffu, all);
    any = __reduce_or_sync(0xffffffffu, any);
    if (lane == 0) {
        atomicAnd(&s.mask[0], all);
        atomicOr(&s.mask[1], any);
    }
    for (int i = tid; i < CL_WARPS * RADIX; i += CL_THREADS) (&s.hist[0][0])[i] = 0;
    cluster_sync(cl);
    all = ~0u;
    any = 0u;
#pragma unroll
    for (int r = 0; r < 8; ++r) {  // the loads of every block in flight at once
        if (r < cl) {
            all &= r == rank ? s.mask[0] : cluster_load(&s.mask[0], r);
            any |= r == rank ? s.mask[1] : cluster_load(&s.mask[1], r);
        }
    }
    const unsigned varies = all ^ any;  // the key bits that differ within the row

    int cur = 0;
    for (int shift = 0; shift < 32; shift += RADIX_BITS) {
        if (((varies >> shift) & (RADIX - 1)) == 0) continue;  // the same in every block
        const uint2* in = s_pair + span * cur;
        uint2* out = s_pair + span * (cur ^ 1);
        for (int i = lo + lane; i < hi; i += 32)
            atomicAdd(&s.hist[warp][(in[i].x >> shift) & (RADIX - 1)], 1u);
        __syncthreads();
        if (tid < RADIX) {
            unsigned run = 0;
#pragma unroll
            for (int w = 0; w < CL_WARPS; ++w) {
                const unsigned c = s.hist[w][tid];
                s.hist[w][tid] = run;
                run += c;
            }
            s.tot[tid] = run;
        }
        cluster_sync(cl);  // every block's digit counts
        unsigned excl = 0;
        if (tid < RADIX) {
            // digit tid's first position: the row's keys of smaller digits,
            // then this digit's keys in the blocks before this one
            unsigned n_digit = 0, before = 0;
#pragma unroll
            for (int r = 0; r < 8; ++r) {
                if (r < cl) {
                    const unsigned v = r == rank ? s.tot[tid] : cluster_load(&s.tot[tid], r);
                    n_digit += v;
                    before += r < rank ? v : 0u;
                }
            }
            unsigned x = n_digit;
            for (int off = 1; off < 32; off <<= 1) {
                const unsigned y = __shfl_up_sync(0xffffffffu, x, off);
                if (lane >= off) x += y;
            }
            if (lane == 31) s.wsum[warp] = x;
            excl = x - n_digit + before;
        }
        __syncthreads();
        if (tid < RADIX) {
#pragma unroll
            for (int w = 0; w < RADIX / 32; ++w) excl += w < warp ? s.wsum[w] : 0u;
            s.base[tid] = excl;
        }
        __syncthreads();
        for (int i0 = lo; i0 < hi; i0 += 32) {
            const int i = i0 + lane;
            const bool act = i < hi;
            const uint2 kv = act ? in[i] : make_uint2(0u, 0u);
            const unsigned d = (kv.x >> shift) & (RADIX - 1);
            const unsigned peers = digit_peers(d, act);
            const unsigned ahead = __popc(peers & lanes_below);
            const unsigned pos = act ? s.base[d] + s.hist[warp][d] + ahead : 0u;
            __syncwarp();
            if (act && ahead == 0) s.hist[warp][d] += __popc(peers);
            if (act) {
                const unsigned dst = div_by(pos, span_m), off = pos - dst * (unsigned)span;
                if ((int)dst == rank) out[off] = kv;
                else cluster_store(out + off, dst, kv);
            }
            __syncwarp();  // the next round reads this round's counts
        }
        // this warp's counts start at 0 for the next pass (no other warp
        // reads them after the barrier before the scatter)
        for (int d = lane; d < RADIX; d += 32) s.hist[warp][d] = 0;
        cluster_sync(cl);  // every pair of the pass has landed
        cur ^= 1;
    }
    // no block leaves while another may still read its shared memory
    if (cl > 1) cluster_arrive();
    const uint2* fin = s_pair + span * cur;
    const size_t row = (size_t)b * ncells + first;
    for (int i = tid; i < cnt; i += CL_THREADS) {
        const uint2 kv = fin[i];
        tnear[row + i] = __uint_as_float(kv.x);
        slist[row + i] = (int)kv.y;
    }
    if (cl > 1) cluster_wait();
}

// the cluster route's block span and dynamic shared memory for `ncells`
// cells in clusters of `cl` blocks; false where the route cannot take them
static bool cluster_shape(int ncells, int cl, int* span, size_t* smem) {
    if (ncells < 1 || !(cl == 1 || cl == 2 || cl == 4 || cl == 8)) return false;
    *span = (ncells + cl - 1) / cl;
    *smem = 2 * sizeof(uint2) * (size_t)*span;
    if (*span > RT_SPAN_MAX) return false;
    return cudaFuncSetAttribute(rt_prepare_cluster_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem) == cudaSuccess;
}

// clusters of `cl` blocks the card holds at once
static int cluster_capacity(int nblocks, int cl, size_t smem, int* clusters) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nblocks * cl);
    cfg.blockDim = dim3(CL_THREADS);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaOccupancyMaxActiveClusters(clusters, rt_prepare_cluster_kernel, &cfg);
}

extern "C" int rx_rt_prepare_cluster(const float* ox, const float* oy, const float* oz,
                                     const float* dx, const float* dy, const float* dz,
                                     const float* cbox, float t_cap, float* boxes, float* tnear,
                                     int* slist, int ncells, int cl, int nby, int nbx, int height,
                                     int width, void* stream) {
    int span;
    size_t smem;
    if (!cluster_shape(ncells, cl, &span, &smem)) return (int)cudaErrorInvalidValue;
    int clusters = 0;
    const int err = cluster_capacity(nby * nbx, cl, smem, &clusters);
    if (err != 0) return err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    RayFields rays;
    rays.f[0] = ox;
    rays.f[1] = oy;
    rays.f[2] = oz;
    rays.f[3] = dx;
    rays.f[4] = dy;
    rays.f[5] = dz;
    return launch_clustered(rt_prepare_cluster_kernel, dim3(nby * nbx * cl), CL_THREADS, smem,
                            static_cast<cudaStream_t>(stream), dim3(cl, 1, 1), rays, cbox,
                            t_cap, boxes, tnear, slist, ncells, cl, span, nbx, height, width);
}

// registers, static and dynamic shared memory, blocks an SM holds at once
// and clusters the card holds at once, for `ncells` cells in clusters of cl
extern "C" int rx_rt_cluster_resources(int ncells, int cl, int* out) {
    int span;
    size_t smem;
    if (!cluster_shape(ncells, cl, &span, &smem)) return (int)cudaErrorInvalidValue;
    const int err = kernel_resources(rt_prepare_cluster_kernel, CL_THREADS, smem, out);
    if (err != 0) return err;
    return cluster_capacity(1, cl, smem, out + 4);
}

// ------------------------------------------------- the global preparation

#define LG_THREADS 512
#define LG_WARPS (LG_THREADS / 32)
#define LG_ITEMS 8                          // pairs a thread holds in a pass
#define LG_MINB 3                           // blocks of a pass an SM holds at least
#define LG_TILE (LG_THREADS * LG_ITEMS)     // pairs a block of a pass sorts: 4,096
#define LG_COUNT_TILE 16384                 // cells a block of the count takes
#define LG_PASSES (32 / RADIX_BITS)
// a row's counters in the scratch: the digit counts of each byte, the AND
// and the OR of its keys, and the next tile of each pass
#define LG_ROW_HIST 0
#define LG_ROW_AND (LG_PASSES * RADIX)
#define LG_ROW_OR (LG_ROW_AND + 1)
#define LG_ROW_TICKET (LG_ROW_OR + 1)
#define LG_ROW_WORDS (LG_ROW_TICKET + LG_PASSES)
// a look-back word: its status in the upper bits (0 none; in pass p, 2p + 1
// the tile's own count, 2p + 2 the count of the row's tiles up to it), the
// count in the lower LB_SHIFT bits
#define LB_SHIFT 28
#define LB_COUNT ((1u << LB_SHIFT) - 1u)

// The global route's scratch, u32 words: the pairs of a pass (nrows * ncells
// keys, then as many cells), each row's LG_ROW_WORDS counters, and each
// row's look-back words (RADIX a tile).
struct LargeScratch {
    unsigned *key, *cell, *rows, *look;
    __host__ __device__ LargeScratch(unsigned* base, int ncells, int nrows) {
        const size_t n = (size_t)nrows * ncells;
        key = base;
        cell = base + n;
        rows = base + 2 * n;
        look = rows + (size_t)nrows * LG_ROW_WORDS;
    }
    static size_t words(int ncells, int tiles, int nrows) {
        return (size_t)nrows * (2 * (size_t)ncells + LG_ROW_WORDS + (size_t)tiles * RADIX);
    }
};

static __device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
static __device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
    unsigned v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// One block a ray block: its boxes, and its row's counters and look-back
// words set for the count and the passes.
__global__ void __launch_bounds__(RT_THREADS) rt_prepare_large_boxes(
    const RayFields rays, float* __restrict__ boxes, unsigned* __restrict__ scratch, int ncells,
    int tiles, int nrows, int nbx, int height, int width) {
    __shared__ float s_part[RT_WARPS][12];
    __shared__ float s_box[12];
    const int b = blockIdx.x;
    block_boxes<RT_THREADS>(rays, s_part, s_box, boxes, b, nbx, height, width);
    const LargeScratch L(scratch, ncells, nrows);
    unsigned* rs = L.rows + (size_t)b * LG_ROW_WORDS;
    for (int i = threadIdx.x; i < LG_ROW_WORDS; i += RT_THREADS) rs[i] = i == LG_ROW_AND ? ~0u : 0u;
    unsigned* lk = L.look + (size_t)b * tiles * RADIX;
    for (int i = threadIdx.x; i < tiles * RADIX; i += RT_THREADS) lk[i] = 0u;
}

// Blocks of LG_COUNT_TILE cells of a row: each cell's key, counted into the
// row's digit counts of every byte (they do not depend on the order) and
// into its AND and OR. Nothing is written per key.
__global__ void __launch_bounds__(LG_THREADS) rt_prepare_large_count(
    const float* __restrict__ cbox, const float* __restrict__ boxes, float t_cap,
    unsigned* __restrict__ scratch, int ncells, int ctiles, int nrows) {
    __shared__ unsigned s_cnt[LG_PASSES * RADIX];
    __shared__ float s_box[12];
    const int b = blockIdx.x / ctiles, first = (blockIdx.x % ctiles) * LG_COUNT_TILE;
    const int cnt = min(LG_COUNT_TILE, ncells - first);
    const int tid = threadIdx.x, lane = tid & 31;
    if (tid < 12) s_box[tid] = boxes[(size_t)b * 12 + tid];
    for (int i = tid; i < LG_PASSES * RADIX; i += LG_THREADS) s_cnt[i] = 0u;
    __syncthreads();
    unsigned all = ~0u, any = 0u;
    for (int i0 = 0; i0 < cnt; i0 += LG_THREADS) {
        const int i = i0 + tid;
        const bool act = i < cnt;
        const unsigned k = act ? (unsigned)(cell_key(cbox, s_box, first + i, t_cap) >> 32) : 0u;
        const unsigned wall = __reduce_and_sync(0xffffffffu, act ? k : ~0u);
        const unsigned wany = __reduce_or_sync(0xffffffffu, act ? k : 0u);
        const unsigned n = __popc(__ballot_sync(0xffffffffu, act));
        all &= wall;
        any |= wany;
#pragma unroll
        for (int q = 0; q < LG_PASSES; ++q) {
            const int shift = q * RADIX_BITS;
            if ((((wall ^ wany) >> shift) & (RADIX - 1)) == 0) {  // one digit in the warp
                if (lane == 0 && n) atomicAdd(&s_cnt[q * RADIX + ((wall >> shift) & (RADIX - 1))], n);
            } else if (act) {
                atomicAdd(&s_cnt[q * RADIX + ((k >> shift) & (RADIX - 1))], 1u);
            }
        }
    }
    __syncthreads();
    unsigned* rs = LargeScratch(scratch, ncells, nrows).rows + (size_t)b * LG_ROW_WORDS;
    for (int i = tid; i < LG_PASSES * RADIX; i += LG_THREADS) {
        const unsigned v = s_cnt[i];
        if (v) atomicAdd(rs + LG_ROW_HIST + i, v);
    }
    if (lane == 0) {
        atomicAnd(rs + LG_ROW_AND, all);
        atomicOr(rs + LG_ROW_OR, any);
    }
}

// What a block of a pass keeps besides its pairs (static shared memory;
// rt_kernel.GLOBAL_SMEM_STATIC is its size).
struct LargeShared {
    unsigned hist[LG_WARPS][RADIX];  // each warp's digit counts, then their prefix over warps
    unsigned start[RADIX];           // the tile's first position of each digit
    unsigned base[RADIX];            // a digit's position in the row less its position in the tile
    unsigned wsum[2][RADIX / 32];
    float box[12];
    int tile;
};

// Pass `pass` of the global route: the row's byte `pass` (bits 8 pass to
// 8 pass + 7 of the key) sorted stably, one tile of LG_TILE pairs a block.
// Blocks take their tiles in the order they start (a ticket a row), so that
// every tile a block waits for in the look-back has a block running or done.
__global__ void __launch_bounds__(LG_THREADS, LG_MINB) rt_prepare_large_kernel(
    const float* __restrict__ cbox, const float* __restrict__ boxes, float t_cap,
    unsigned* __restrict__ tnear, unsigned* __restrict__ slist, unsigned* __restrict__ scratch,
    int ncells, int tiles, int nrows, int pass) {
    __shared__ LargeShared s;
    extern __shared__ uint2 s_pair[];  // LG_TILE (key, cell) pairs in digit order

    const int b = blockIdx.x / tiles;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const LargeScratch L(scratch, ncells, nrows);
    unsigned* rs = L.rows + (size_t)b * LG_ROW_WORDS;
    const unsigned all = rs[LG_ROW_AND], varies = all ^ rs[LG_ROW_OR];
    unsigned active = 0;  // the bytes in which the row's keys differ
#pragma unroll
    for (int q = 0; q < LG_PASSES; ++q)
        if ((varies >> (q * RADIX_BITS)) & (RADIX - 1)) active |= 1u << q;
    const size_t row = (size_t)b * ncells;
    if (!((active >> pass) & 1u)) {
        if (pass == 0 && active == 0) {  // one key for the whole row: the cells in order
            const int first = (blockIdx.x % tiles) * LG_TILE;
            for (int i = first + tid; i < min(ncells, first + LG_TILE); i += LG_THREADS) {
                tnear[row + i] = all;
                slist[row + i] = (unsigned)i;
            }
        }
        return;
    }
    // the passes before this one, and after it; the last writes the outputs
    // and the others alternate between them and the scratch
    const int done = __popc(active & ((1u << pass) - 1u));
    const int left = __popc(active >> pass) - 1;
    unsigned *out_k = tnear, *out_c = slist;
    const unsigned *in_k = L.key, *in_c = L.cell;
    if (left & 1) {
        out_k = L.key;
        out_c = L.cell;
        in_k = tnear;
        in_c = slist;
    }
    const int shift = pass * RADIX_BITS;
    const unsigned row_count = tid < RADIX ? rs[LG_ROW_HIST + pass * RADIX + tid] : 0u;
    if (tid == 0) s.tile = (int)atomicAdd(rs + LG_ROW_TICKET + pass, 1u);
    if (tid < 12 && done == 0) s.box[tid] = boxes[(size_t)b * 12 + tid];
    for (int i = tid; i < LG_WARPS * RADIX; i += LG_THREADS) (&s.hist[0][0])[i] = 0u;
    __syncthreads();

    const int tile = s.tile, first = tile * LG_TILE;
    const int cnt = min(LG_TILE, ncells - first);
    const unsigned lanes_below = (1u << lane) - 1u;
    // warp w takes positions [w * per, (w + 1) * per) of the tile
    const int per = (cnt + LG_WARPS - 1) / LG_WARPS;
    const int lo = min(cnt, warp * per), hi = min(cnt, lo + per);
    unsigned key[LG_ITEMS], cell[LG_ITEMS], rank[LG_ITEMS];
#pragma unroll
    for (int r = 0; r < LG_ITEMS; ++r) {
        const int i = lo + r * 32 + lane;
        const bool act = i < hi;
        if (done == 0) {  // the first pass of the row computes its keys again
            key[r] = act ? (unsigned)(cell_key(cbox, s.box, first + i, t_cap) >> 32) : 0u;
            cell[r] = (unsigned)(first + i);
        } else {
            key[r] = act ? in_k[row + first + i] : 0u;
            cell[r] = act ? in_c[row + first + i] : 0u;
        }
    }
    // each pair's rank among the warp's pairs of its digit, and the warp's
    // digit counts
#pragma unroll
    for (int r = 0; r < LG_ITEMS; ++r) {
        const bool act = lo + r * 32 + lane < hi;
        const unsigned d = (key[r] >> shift) & (RADIX - 1);
        const unsigned peers = digit_peers(d, act);
        const unsigned ahead = __popc(peers & lanes_below);
        const unsigned prior = act ? s.hist[warp][d] : 0u;
        __syncwarp();
        if (act && ahead == 0) s.hist[warp][d] = prior + __popc(peers);
        __syncwarp();
        rank[r] = prior + ahead;
    }
    __syncthreads();
    // per digit: the counts of the earlier warps, the tile's count (published
    // at once for the later tiles), and exclusive scans over the digits of
    // the tile's counts and of the row's
    unsigned tot = 0, x = 0, y = 0;
    unsigned* lk = L.look + ((size_t)b * tiles + tile) * RADIX;
    if (tid < RADIX) {
#pragma unroll
        for (int w = 0; w < LG_WARPS; ++w) {
            const unsigned c = s.hist[w][tid];
            s.hist[w][tid] = tot;
            tot += c;
        }
        st_relaxed(lk + tid, ((unsigned)(tile == 0 ? 2 * pass + 2 : 2 * pass + 1) << LB_SHIFT) | tot);
        x = tot;
        y = row_count;
        for (int off = 1; off < 32; off <<= 1) {
            const unsigned xu = __shfl_up_sync(0xffffffffu, x, off);
            const unsigned yu = __shfl_up_sync(0xffffffffu, y, off);
            if (lane >= off) {
                x += xu;
                y += yu;
            }
        }
        if (lane == 31) {
            s.wsum[0][warp] = x;
            s.wsum[1][warp] = y;
        }
        x -= tot;
        y -= row_count;
    }
    __syncthreads();
    if (tid < RADIX) {
#pragma unroll
        for (int w = 0; w < RADIX / 32; ++w) {
            x += w < warp ? s.wsum[0][w] : 0u;
            y += w < warp ? s.wsum[1][w] : 0u;
        }
        s.start[tid] = x;
        s.base[tid] = y - x;
    }
    __syncthreads();
    // the tile's pairs in digit order in shared memory
#pragma unroll
    for (int r = 0; r < LG_ITEMS; ++r) {
        if (lo + r * 32 + lane < hi) {
            const unsigned d = (key[r] >> shift) & (RADIX - 1);
            s_pair[s.start[d] + s.hist[warp][d] + rank[r]] = make_uint2(key[r], cell[r]);
        }
    }
    // the digit's count in the row's earlier tiles (decoupled look-back):
    // add the tiles' own counts back to the first that has published its
    // inclusive count
    if (tid < RADIX && tile > 0) {
        const unsigned own = 2 * pass + 1, incl = 2 * pass + 2;
        unsigned excl = 0;
        for (int t = tile - 1; t >= 0;) {
            const unsigned v = ld_relaxed(L.look + ((size_t)b * tiles + t) * RADIX + tid);
            const unsigned st = v >> LB_SHIFT;
            if (st < own) continue;  // not yet published in this pass
            excl += v & LB_COUNT;
            if (st == incl) break;
            --t;
        }
        st_relaxed(lk + tid, (incl << LB_SHIFT) | (excl + tot));
        s.base[tid] += excl;
    }
    __syncthreads();
    // out in digit runs: consecutive pairs of one digit to consecutive places
    for (int i = tid; i < cnt; i += LG_THREADS) {
        const uint2 kv = s_pair[i];
        const size_t g = row + (s.base[(kv.x >> shift) & (RADIX - 1)] + (unsigned)i);
        out_k[g] = kv.x;
        out_c[g] = kv.y;
    }
}

extern "C" int rx_rt_prepare_large(const float* ox, const float* oy, const float* oz,
                                   const float* dx, const float* dy, const float* dz,
                                   const float* cbox, float t_cap, float* boxes, float* tnear,
                                   int* slist, unsigned* scratch, long long scratch_bytes,
                                   int ncells, int nby, int nbx, int height, int width,
                                   void* stream) {
    const int nrows = nby * nbx;
    const int tiles = (ncells + LG_TILE - 1) / LG_TILE;
    const int ctiles = (ncells + LG_COUNT_TILE - 1) / LG_COUNT_TILE;
    if (ncells < 1 || (unsigned)ncells > LB_COUNT ||
        scratch_bytes < (long long)(4 * LargeScratch::words(ncells, tiles, nrows)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(uint2) * LG_TILE;
    cudaError_t err = cudaFuncSetAttribute(rt_prepare_large_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    RayFields rays;
    rays.f[0] = ox;
    rays.f[1] = oy;
    rays.f[2] = oz;
    rays.f[3] = dx;
    rays.f[4] = dy;
    rays.f[5] = dz;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    rt_prepare_large_boxes<<<nrows, RT_THREADS, 0, st>>>(rays, boxes, scratch, ncells, tiles,
                                                         nrows, nbx, height, width);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rt_prepare_large_count<<<nrows * ctiles, LG_THREADS, 0, st>>>(cbox, boxes, t_cap, scratch,
                                                                   ncells, ctiles, nrows);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    for (int pass = 0; pass < LG_PASSES; ++pass) {
        rt_prepare_large_kernel<<<nrows * tiles, LG_THREADS, smem, st>>>(
            cbox, boxes, t_cap, reinterpret_cast<unsigned*>(tnear),
            reinterpret_cast<unsigned*>(slist), scratch, ncells, tiles, nrows, pass);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return 0;
}

// ------------------------------------------------------------------ walk

// the first 256 threads: start the copy of cell c's 64 rows of 16 floats (4 KB)
static __device__ __forceinline__ void cell_start(float* dst, const float* tab, int c) {
    const int q = threadIdx.x;
    if (q < CELL_FLOATS / 4) {
        const float* src = tab + (size_t)c * CELL_FLOATS + 4 * q;
        const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + 4 * q));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
    }
}
static __device__ __forceinline__ void cell_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group (the newest) is still in flight
static __device__ __forceinline__ void cell_wait_older() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
static __device__ __forceinline__ void cell_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The walk: one block per 8x128 ray block, one ray per thread.
__global__ void __launch_bounds__(WALK_THREADS) rt_kernel(
    const float* __restrict__ tab, const float* __restrict__ cbox,
    const float* __restrict__ tnear, const int* __restrict__ slist,
    const float* __restrict__ tcap_row, const RayFields rays, float* __restrict__ t_out,
    int* __restrict__ idx_out, int ncells, int nbx, int height, int width) {
    __shared__ __align__(16) float s_tri[2][CELL_FLOATS];
    __shared__ float s_red[2][WALK_WARPS];

    const int b = blockIdx.x;
    const int by = b / nbx, bx = b % nbx;
    const int tid = threadIdx.x;
    const float* tn_row = tnear + (size_t)b * ncells;
    const int* sl_row = slist + (size_t)b * ncells;
    const float tcap = tcap_row[0];

    const long long o = ray_offset(by, bx, tid, height, width);
    const float ox = o >= 0 ? rays.f[0][o] : 1e8f;
    const float oy = o >= 0 ? rays.f[1][o] : 1e8f;
    const float oz = o >= 0 ? rays.f[2][o] : 1e8f;
    const float dx = o >= 0 ? rays.f[3][o] : 0.0f;
    const float dy = o >= 0 ? rays.f[4][o] : 0.0f;
    const float dz = o >= 0 ? rays.f[5][o] : 0.0f;
    const bool live = ox < PARKED;
    const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
    // per-ray scene-exit cap: no hit lies beyond the ray's exit from the
    // scene AABB
    float t_exit = nmax((tcap_row[1] - ox) * ivx, (tcap_row[4] - ox) * ivx);
    t_exit = nmin(t_exit, nmax((tcap_row[2] - oy) * ivy, (tcap_row[5] - oy) * ivy));
    t_exit = nmin(t_exit, nmax((tcap_row[3] - oz) * ivz, (tcap_row[6] - oz) * ivz));
    const float tcv = nmin(tcap, nmax(t_exit, 0.0f) + 1e-3f);
    float best = INFINITY;
    int idx = -1;

    // One reduction round gives the block's bound (the max over live rays of
    // min(best, cap); dead rays bound it at 0, so an all-dead block never
    // walks) and the slab vote for shortlist entry `e`: does any live ray
    // enter that cell closer than min(best, cap)? The vote rides on the
    // barrier itself (__syncthreads_or); each warp leaves its max in a slot
    // of its own, the slots of two rounds alternating, so that one barrier
    // a round is enough.
    int round = 0;
    float maxt = 0.0f;
    bool any = false;
    auto reduce = [&](int e, bool refresh) {
        float m = live ? nmin(best, tcv) : 0.0f;
        m = nmax(0.0f, m);
        bool vote = false;
        if (e < ncells) {
            const float* cb = cbox + 8 * sl_row[e];
            const float t0x = (cb[0] - ox) * ivx, t1x = (cb[3] - ox) * ivx;
            const float t0y = (cb[1] - oy) * ivy, t1y = (cb[4] - oy) * ivy;
            const float t0z = (cb[2] - oz) * ivz, t1z = (cb[5] - oz) * ivz;
            const float tn = nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmin(t0z, t1z));
            const float tf = nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z));
            vote = live && (tf >= nmax(tn, 0.0f)) && (tn < nmin(best, tcv));
        }
        for (int w = 16; w > 0; w >>= 1) m = nmax(m, __shfl_xor_sync(0xffffffffu, m, w));
        const int slot = round & 1;
        if ((tid & 31) == 0) s_red[slot][tid >> 5] = m;
        any = __syncthreads_or(vote);
        if (refresh) {
            float mm = s_red[slot][0];
#pragma unroll
            for (int w = 1; w < WALK_WARPS; ++w) mm = nmax(mm, s_red[slot][w]);
            maxt = mm;
        }
        ++round;
    };

    reduce(0, true);
    int i = 0;
    if (ncells > 0 && tn_row[0] < maxt) cell_start(s_tri[0], tab, sl_row[0]);
    cell_commit();
    while (i < ncells && tn_row[i] < maxt) {
        const int c = sl_row[i];
        // the next entry's triangles fly while this cell is tested; ring
        // half (i+1)&1 was last read in iteration i-1, and the reduction's
        // barrier lies behind every thread
        if (i + 1 < ncells) cell_start(s_tri[(i + 1) & 1], tab, sl_row[i + 1]);
        cell_commit();
        // cell c's copy has landed, tested or not: the next iteration starts
        // a copy into the same ring half, and two pending groups that write
        // one address are not ordered
        cell_wait_older();
        if (any) {
            __syncthreads();  // every thread's part of cell c has landed
            const float* tri = s_tri[i & 1];
            for (int k = 0; k < CELL; ++k) {
                const float4* T = reinterpret_cast<const float4*>(tri + 16 * k);
                const float4 q0 = T[0], q1 = T[1], q2 = T[2];
                const float ax = q0.x, ay = q0.y, az = q0.z;
                const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
                const float e2x = q1.z, e2y = q1.w, e2z = q2.x;
                const float hx = dy * e2z - dz * e2y;
                const float hy = dz * e2x - dx * e2z;
                const float hz = dx * e2y - dy * e2x;
                const float det = e1x * hx + e1y * hy + e1z * hz;
                const bool okd = fabsf(det) >= 1e-6f;
                const float f = okd ? __frcp_rn(det) : 0.0f;
                const float svx = ox - ax, svy = oy - ay, svz = oz - az;
                const float uu = f * (svx * hx + svy * hy + svz * hz);
                // most pairs fail here; a warp in which every ray fails
                // skips the rest of the test
                if (okd && (uu >= 0.0f) && (uu <= 1.0f)) {
                    const float qx = svy * e1z - svz * e1y;
                    const float qy = svz * e1x - svx * e1z;
                    const float qz = svx * e1y - svy * e1x;
                    const float vv = f * (dx * qx + dy * qy + dz * qz);
                    const float tt = f * (e2x * qx + e2y * qy + e2z * qz);
                    const bool ok = (vv >= 0.0f) && (uu + vv <= 1.0f) && (tt > 1e-4f) &&
                                    (tt < tcap);
                    if (ok && tt < best) {
                        best = tt;
                        idx = c * CELL + k;
                    }
                }
            }
        }
        // refresh the early-exit bound while entries remain, and vote on
        // the next entry
        const bool more = tn_row[min(i + 1, ncells - 1)] < BIG;
        reduce(i + 1, more);
        ++i;
    }
    cell_wait_all();  // a prefetched cell the walk never reached

    if (o >= 0) {
        t_out[o] = best;
        idx_out[o] = idx;
    }
}

// which = 0: the walk, 1: the preparation of a scene of `ncells` cells, 2:
// the preparation of a larger scene; out[0..3]: registers, static and
// dynamic shared memory, blocks an SM holds at once
extern "C" int rx_rt_resources(int which, int ncells, int* out) {
    if (which == 2) {
        const size_t smem = sizeof(uint2) * LG_TILE;
        const cudaError_t err = cudaFuncSetAttribute(
            rt_prepare_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        return kernel_resources(rt_prepare_large_kernel, LG_THREADS, smem, out);
    }
    return which ? kernel_resources(rt_prepare_kernel, RT_THREADS,
                                    sizeof(unsigned long long) * (size_t)ncells, out)
                 : kernel_resources(rt_kernel, WALK_THREADS, 0, out);
}

extern "C" int rx_rt_intersect(const float* tab, const float* cbox, const float* tnear,
                               const int* slist, const float* tcap, const float* ox,
                               const float* oy, const float* oz, const float* dx,
                               const float* dy, const float* dz, float* t, int* idx, int ncells,
                               int nby, int nbx, int height, int width, void* stream) {
    RayFields rays;
    rays.f[0] = ox;
    rays.f[1] = oy;
    rays.f[2] = oz;
    rays.f[3] = dx;
    rays.f[4] = dy;
    rays.f[5] = dz;
    rt_kernel<<<nby * nbx, WALK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        tab, cbox, tnear, slist, tcap, rays, t, idx, ncells, nbx, height, width);
    return (int)cudaGetLastError();
}

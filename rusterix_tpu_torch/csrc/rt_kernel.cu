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
// - Above a cluster of 8 blocks (8 * RT_SPAN_MAX cells), rt_kernel's
//   CLUSTER_MAX_CELLS, `rt_prepare_large_kernel` takes the scene: the same
//   boxes and keys, written to a global scratch of one power-of-two row a
//   ray block, sorted by a bitonic network (every stage whose partners lie
//   within a chunk of SORT_CHUNK keys in shared memory, the wider ones over
//   the row in global memory; 2 + 2 log2(n / SORT_CHUNK) passes of the row
//   through the scratch), then written out as tnear and slist.
// The keys are unique (the cell is their low half), so every route gives
// the same bits.
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

#define RT_BH 8
#define RT_BW 128
#define RT_THREADS 256                      // the preparation: 4 rays per thread
#define RT_WARPS (RT_THREADS / 32)
#define WALK_THREADS (RT_BH * RT_BW)        // the walk: one ray per thread
#define WALK_WARPS (WALK_THREADS / 32)
#define CELL 64
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

#define SORT_CHUNK 4096  // keys a block sorts in shared memory at once (32 KB)

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

// One round of a bitonic sorting network over a[0..n) (n a power of two,
// a[i] the key at global position base + i): every pair (i, i + j) with
// bit j of i clear is put in ascending order where bit k of base + i is
// clear, descending where it is set. No barrier.
static __device__ __forceinline__ void bitonic_round(unsigned long long* a, int n, int base,
                                                     int k, int j) {
    for (int q = threadIdx.x; q < n / 2; q += RT_THREADS) {
        const int i = 2 * j * (q / j) + (q % j);
        const unsigned long long x = a[i], y = a[i + j];
        const bool up = ((base + i) & k) == 0;
        if ((x > y) == up) {
            a[i] = y;
            a[i + j] = x;
        }
    }
}

// Rounds j = j0, j0 / 2, ..., 1 of stage k on each SORT_CHUNK-key chunk of
// row[0..n) in shared memory (j0 < chunk). Ends with a barrier.
static __device__ __forceinline__ void bitonic_chunks(unsigned long long* row, int n,
                                                      unsigned long long* s_sort, int chunk,
                                                      int k_first, int k_last) {
    for (int base = 0; base < n; base += chunk) {
        for (int i = threadIdx.x; i < chunk; i += RT_THREADS) s_sort[i] = row[base + i];
        __syncthreads();
        for (int k = k_first; k <= k_last; k <<= 1) {
            for (int j = min(k >> 1, chunk >> 1); j > 0; j >>= 1) {
                bitonic_round(s_sort, chunk, base, k, j);
                __syncthreads();
            }
        }
        for (int i = threadIdx.x; i < chunk; i += RT_THREADS) row[base + i] = s_sort[i];
        __syncthreads();
    }
}

// The preparation for scenes whose keys outgrow a block's shared memory: one
// block a ray block, its keys in its row of `keys` (n2 >= ncells, a power of
// two; the padding keys ~0 sort last), sorted ascending by a bitonic network.
__global__ void __launch_bounds__(RT_THREADS) rt_prepare_large_kernel(
    const RayFields rays, const float* __restrict__ cbox, float t_cap,
    float* __restrict__ boxes, float* __restrict__ tnear, int* __restrict__ slist,
    unsigned long long* keys, int ncells, int n2, int nbx, int height, int width) {
    __shared__ float s_part[RT_WARPS][12];
    __shared__ float s_box[12];
    __shared__ unsigned long long s_sort[SORT_CHUNK];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    block_boxes<RT_THREADS>(rays, s_part, s_box, boxes, b, nbx, height, width);

    unsigned long long* row = keys + (size_t)b * n2;
    for (int c = tid; c < n2; c += RT_THREADS)
        row[c] = c < ncells ? cell_key(cbox, s_box, c, t_cap) : ~0ull;
    __syncthreads();

    const int chunk = n2 < SORT_CHUNK ? n2 : SORT_CHUNK;
    // stages 2..chunk: each chunk sorted whole in shared memory (alternate
    // chunks descending, so that pairs of chunks form bitonic sequences)
    bitonic_chunks(row, n2, s_sort, chunk, 2, chunk);
    // the wider stages: the rounds whose partners are a chunk or more apart
    // over the row in global memory, the rest chunk by chunk
    for (int k = 2 * chunk; k <= n2; k <<= 1) {
        for (int j = k >> 1; j >= chunk; j >>= 1) {
            bitonic_round(row, n2, 0, k, j);
            __syncthreads();
        }
        bitonic_chunks(row, n2, s_sort, chunk, k, k);
    }

    for (int r = tid; r < ncells; r += RT_THREADS) {
        const unsigned long long key = row[r];
        tnear[(size_t)b * ncells + r] = __uint_as_float((unsigned)(key >> 32));
        slist[(size_t)b * ncells + r] = (int)(unsigned)(key & 0xffffffffull);
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

extern "C" int rx_rt_prepare_large(const float* ox, const float* oy, const float* oz,
                                   const float* dx, const float* dy, const float* dz,
                                   const float* cbox, float t_cap, float* boxes, float* tnear,
                                   int* slist, unsigned long long* keys, int ncells, int n2,
                                   int nby, int nbx, int height, int width, void* stream) {
    if (n2 < ncells || (n2 & (n2 - 1)) != 0) return (int)cudaErrorInvalidValue;
    RayFields rays;
    rays.f[0] = ox;
    rays.f[1] = oy;
    rays.f[2] = oz;
    rays.f[3] = dx;
    rays.f[4] = dy;
    rays.f[5] = dz;
    rt_prepare_large_kernel<<<nby * nbx, RT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, cbox, t_cap, boxes, tnear, slist, keys, ncells, n2, nbx, height, width);
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
    if (which == 2) return kernel_resources(rt_prepare_large_kernel, RT_THREADS, 0, out);
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

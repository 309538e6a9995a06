// Thread block cluster primitives (PTX) and a resource query, shared by the
// kernels of this directory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The cluster barrier in two halves: every thread of every block of the
// cluster arrives, then waits; shared-memory writes before the arrive,
// local or remote, are visible to every block after the wait.
static __device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// address of `p` (a shared-memory location of this block) in block `rank`
static __device__ __forceinline__ uint32_t cluster_map(const void* p, int rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(smem_u32(p)), "r"(rank));
    return remote;
}
// read a u32 at the same shared-memory offset in block `rank`
static __device__ __forceinline__ uint32_t cluster_load(const uint32_t* p, int rank) {
    uint32_t v;
    asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(cluster_map(p, rank)) : "memory");
    return v;
}
// write a uint2 at the same shared-memory offset in block `rank`
static __device__ __forceinline__ void cluster_store(uint2* p, int rank, uint2 v) {
    asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(cluster_map(p, rank)),
                 "r"(v.x), "r"(v.y)
                 : "memory");
}
// registers, static and dynamic shared memory of a kernel and the blocks of
// it an SM holds at once -> out[0..3]
template <typename Kernel>
static int kernel_resources(Kernel kernel, int threads, size_t dyn_smem, int* out) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dyn_smem);
    if (err != cudaSuccess) return (int)err;
    out[0] = fa.numRegs;
    out[1] = (int)fa.sharedSizeBytes;
    out[2] = (int)dyn_smem;
    out[3] = blocks;
    return 0;
}

// launch `kernel` with thread block clusters of `cluster` blocks along x or y
template <typename... Params, typename... Args>
static int launch_clustered(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                            cudaStream_t stream, dim3 cluster, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster.x;
    attr[0].val.clusterDim.y = cluster.y;
    attr[0].val.clusterDim.z = cluster.z;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

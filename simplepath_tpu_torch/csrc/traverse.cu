// BVH traversal kernels for NVIDIA Hopper (sm_90a): closest-hit and any-hit
// over the unified f32[M,128] record table (row layout: scene/bvh.py).
//
// Replaces the two Pallas TPU kernels of the JAX package,
//   simplepath_tpu/render/pallas_traverse.py::packet_closest  (sp_closest)
//   simplepath_tpu/render/pallas_traverse.py::packet_anyhit   (sp_anyhit)
// and computes, ray for ray, what the JAX package's per-ray formulation
// (render/traverse.py::_bvh_closest / _bvh_any) computes: same visit order,
// same slab and Shirley arithmetic, same tie rules.  The plain PyTorch
// versions beside the wrappers (render/cuda_traverse.py: closest_plain,
// anyhit_plain) are the same algorithm with the batch written out.
//
// What is NOT carried over from the TPU design: the 1024-ray packet with one
// shared stack, the scalar-core stack and the double-buffered row DMA exist
// there because a TPU has no per-lane control flow.  A GPU thread has its
// own: ONE THREAD PER RAY, a private stack of refs, a while loop.
//
// What bounds it on this card: not device-memory bandwidth — the table of a
// few hundred thousand triangles (~18 MB) sits in the 50 MB L2, and each ray
// only moves 32 B in and 17 B out.  The cost is L2/L1 traffic for the
// 512-byte rows (one per visit per ray) and warp divergence (rays of a warp
// popping different rows, or leaf vs internal rows, serialize).  What the
// design does about it: rows are read through the read-only path as 16-byte
// vectors so a warp whose rays visit the same row is served by one L1 line
// fetch per 128 B; children are visited near-to-far so the shrinking best-t
// front culls most of the tree; and the integrator sorts rays between
// bounces (render/integrators.py::_coherence_order) so a warp's rays stay on
// neighbouring rows.  The stack (64 ints) lives in local memory, which L1
// caches.
//
// Numerics that pin `idx` to the plain version's (build: -fmad=false, no
// --use_fast_math, IEEE divide):
//   * min/max propagate NaN like torch.minimum/maximum (CUDA's fminf/fmaxf
//     drop it): (lo - ro) * inf is NaN when the origin lies on a box plane
//     and the direction component is zero, and that child must be culled;
//   * no FMA contraction; operation order of the Shirley test as written in
//     the plain version; one reciprocal and three multiplies;
//   * equal-t ties keep the EARLIER hit (strict < against the running
//     best); children sorted far-to-near by the ray's own unclamped tnear
//     with the 19-pair Batcher network, so ties visit in the same order.
//
// Build (done at first use by render/cuda_traverse.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libsp_traverse.so traverse.cu
// Plain C interface; each entry point launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int W = 8;             // BVH branching factor (scene/bvh.py WIDTH)
constexpr int K = 12;            // triangles per leaf (LEAF_SIZE)
constexpr int ROW_F4 = 32;       // 128 floats per row = 32 float4
constexpr int STACK = 64;        // per-ray stack capacity (STACK_DEPTH)
constexpr int BLOCK = 128;       // threads per block
constexpr float NEG_BIG = -3.0e38f;

__device__ __forceinline__ float pmin(float a, float b) {
    // NaN-propagating minimum (torch.minimum semantics)
    float m = fminf(a, b);
    return (a != a) ? a : ((b != b) ? b : m);
}

__device__ __forceinline__ float pmax(float a, float b) {
    float m = fmaxf(a, b);
    return (a != a) ? a : ((b != b) ? b : m);
}

__device__ __forceinline__ float f4get(const float4& v, int i) {
    return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

struct Ray {
    float ox, oy, oz;
    float dx, dy, dz;
    float ix, iy, iz;   // 1/d, IEEE inf for zero components
    float t_min;
};

// Slab-test the W children of an internal row against the ray, sort the hit
// children far-to-near by unclamped tnear and push them (nearest on top).
__device__ __forceinline__ void visit_internal(const float4* __restrict__ row,
                                               const Ray& r, float cur_t_max,
                                               int* stack, int& sp) {
    float key[W];
    int val[W];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float4 lox = __ldg(row + 0 + h), loy = __ldg(row + 2 + h);
        const float4 loz = __ldg(row + 4 + h), hix = __ldg(row + 6 + h);
        const float4 hiy = __ldg(row + 8 + h), hiz = __ldg(row + 10 + h);
        const float4 ref = __ldg(row + 12 + h);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const float t0x = (f4get(lox, c) - r.ox) * r.ix;
            const float t0y = (f4get(loy, c) - r.oy) * r.iy;
            const float t0z = (f4get(loz, c) - r.oz) * r.iz;
            const float t1x = (f4get(hix, c) - r.ox) * r.ix;
            const float t1y = (f4get(hiy, c) - r.oy) * r.iy;
            const float t1z = (f4get(hiz, c) - r.oz) * r.iz;
            const float tnear = pmax(pmax(pmin(t0x, t1x), pmin(t0y, t1y)),
                                     pmin(t0z, t1z));
            const float tfar = pmin(pmin(pmax(t0x, t1x), pmax(t0y, t1y)),
                                    pmax(t0z, t1z));
            const int cref = (int)f4get(ref, c);
            const bool hit = (pmax(tnear, r.t_min) <= pmin(tfar, cur_t_max))
                             && (tfar >= r.t_min) && (cref != 0);
            key[4 * h + c] = hit ? tnear : -INFINITY;
            val[4 * h + c] = cref;
        }
    }
    // Batcher odd-even mergesort network for 8 lanes, descending by key
    // (the pair list of batcher_pairs(8) in render/cuda_traverse.py)
#define SP_CE(a, b)                                              \
    {                                                            \
        const bool sw = key[a] < key[b];                         \
        const float ka = key[a], kb = key[b];                    \
        const int va = val[a], vb = val[b];                      \
        key[a] = sw ? kb : ka; key[b] = sw ? ka : kb;            \
        val[a] = sw ? vb : va; val[b] = sw ? va : vb;            \
    }
    SP_CE(0, 1) SP_CE(2, 3) SP_CE(0, 2) SP_CE(1, 3) SP_CE(1, 2)
    SP_CE(4, 5) SP_CE(6, 7) SP_CE(4, 6) SP_CE(5, 7) SP_CE(5, 6)
    SP_CE(0, 4) SP_CE(2, 6) SP_CE(2, 4) SP_CE(1, 5) SP_CE(3, 7)
    SP_CE(3, 5) SP_CE(1, 2) SP_CE(3, 4) SP_CE(5, 6)
#undef SP_CE
    // same overflow guard as the plain version (pack_records asserts that
    // the tree fits, so it never triggers on a packed table)
    if (sp > STACK - W) sp = STACK - W;
#pragma unroll
    for (int j = 0; j < W; ++j) {
        if (key[j] > NEG_BIG) stack[sp++] = val[j];
    }
}

// Shirley barycentric test of one leaf triangle (v0, e1 = v0-v1, e2 = v0-v2).
__device__ __forceinline__ bool tri_test(float v0x, float v0y, float v0z,
                                         float A, float B, float C,
                                         float D, float E, float F,
                                         const Ray& r, float cur_t_max,
                                         float& t, float& beta, float& gamma) {
    const float G = r.dx, H = r.dy, I = r.dz;
    const float J = v0x - r.ox;
    const float Kk = v0y - r.oy;
    const float L = v0z - r.oz;
    const float EIHF = E * I - H * F;
    const float GFDI = G * F - D * I;
    const float DHEG = D * H - E * G;
    const float denom = A * EIHF + B * GFDI + C * DHEG;
    const float inv = 1.0f / (denom == 0.0f ? 1.0f : denom);
    beta = (J * EIHF + Kk * GFDI + L * DHEG) * inv;
    const float AKJB = A * Kk - J * B;
    const float JCAL = J * C - A * L;
    const float BLKC = B * L - Kk * C;
    gamma = (I * AKJB + H * JCAL + G * BLKC) * inv;
    t = -(F * AKJB + E * JCAL + D * BLKC) * inv;
    return (denom != 0.0f) && (beta > 0.0f) && (beta < 1.0f)
           && (gamma > 0.0f) && (beta + gamma < 1.0f)
           && (t >= r.t_min) && (t <= cur_t_max);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ro,
                                        const float* __restrict__ rd,
                                        const float* __restrict__ t_min, int i) {
    Ray r;
    r.ox = ro[3 * i + 0]; r.oy = ro[3 * i + 1]; r.oz = ro[3 * i + 2];
    r.dx = rd[3 * i + 0]; r.dy = rd[3 * i + 1]; r.dz = rd[3 * i + 2];
    r.ix = 1.0f / r.dx; r.iy = 1.0f / r.dy; r.iz = 1.0f / r.dz;
    r.t_min = t_min[i];
    return r;
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
traverse_kernel(const float4* __restrict__ records,
                const float* __restrict__ ro, const float* __restrict__ rd,
                const float* __restrict__ t_min, const float* __restrict__ t_max,
                int n,
                float* __restrict__ out_t, int* __restrict__ out_idx,
                float* __restrict__ out_beta, float* __restrict__ out_gamma,
                unsigned char* __restrict__ out_flag) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= n) return;              // ragged last block
    const Ray r = load_ray(ro, rd, t_min, i);
    const float ray_t_max = t_max[i];

    int stack[STACK];
    int sp = 1;
    stack[0] = 1;                    // root ref = +1

    float best_t = INFINITY, best_beta = 0.0f, best_gamma = 0.0f;
    int best_idx = -1;
    bool found = false;

    while (sp > 0) {
        const int ref = stack[--sp];
        const float cur_t_max = ANY ? ray_t_max : fminf(ray_t_max, best_t);
        if (ref > 0) {
            visit_internal(records + (size_t)(ref - 1) * ROW_F4, r, cur_t_max,
                           stack, sp);
            continue;
        }
        const float4* row = records + (size_t)(-ref - 1) * ROW_F4;
        const float4 meta = __ldg(row + 27);   // floats 108..111
        const int base = ((int)meta.y << 12) + (int)meta.x;
        const int count = (int)meta.z;
#pragma unroll
        for (int g = 0; g < K / 4; ++g) {
            if (4 * g >= count) break;
            const float4 v0x = __ldg(row + 0 + g), v0y = __ldg(row + 3 + g);
            const float4 v0z = __ldg(row + 6 + g);
            const float4 a4 = __ldg(row + 9 + g), b4 = __ldg(row + 12 + g);
            const float4 c4 = __ldg(row + 15 + g);
            const float4 d4 = __ldg(row + 18 + g), e4 = __ldg(row + 21 + g);
            const float4 f4 = __ldg(row + 24 + g);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float t, beta, gamma;
                const bool ok = tri_test(f4get(v0x, c), f4get(v0y, c), f4get(v0z, c),
                                         f4get(a4, c), f4get(b4, c), f4get(c4, c),
                                         f4get(d4, c), f4get(e4, c), f4get(f4, c),
                                         r, cur_t_max, t, beta, gamma)
                                && (4 * g + c < count);
                if (ANY) {
                    found = found || ok;
                } else if (ok && t < best_t) {
                    // strict <: the earlier of two equal-t hits is kept
                    best_t = t; best_beta = beta; best_gamma = gamma;
                    best_idx = base + 4 * g + c;
                    found = true;
                }
            }
        }
        if (ANY && found) break;
    }

    out_flag[i] = found ? 1 : 0;
    if (!ANY) {
        out_t[i] = best_t;
        out_idx[i] = best_idx;
        out_beta[i] = best_beta;
        out_gamma[i] = best_gamma;
    }
}

}  // namespace

extern "C" int sp_closest(const void* records, const void* ro, const void* rd,
                          const void* t_min, const void* t_max, int n,
                          void* out_t, void* out_idx, void* out_beta,
                          void* out_gamma, void* out_valid, void* stream) {
    if (n > 0) {
        const int grid = (n + BLOCK - 1) / BLOCK;
        traverse_kernel<false><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
            (const float4*)records, (const float*)ro, (const float*)rd,
            (const float*)t_min, (const float*)t_max, n,
            (float*)out_t, (int*)out_idx, (float*)out_beta, (float*)out_gamma,
            (unsigned char*)out_valid);
    }
    return (int)cudaGetLastError();
}

extern "C" int sp_anyhit(const void* records, const void* ro, const void* rd,
                         const void* t_min, const void* t_max, int n,
                         void* out_occluded, void* stream) {
    if (n > 0) {
        const int grid = (n + BLOCK - 1) / BLOCK;
        traverse_kernel<true><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
            (const float4*)records, (const float*)ro, (const float*)rd,
            (const float*)t_min, (const float*)t_max, n,
            nullptr, nullptr, nullptr, nullptr,
            (unsigned char*)out_occluded);
    }
    return (int)cudaGetLastError();
}

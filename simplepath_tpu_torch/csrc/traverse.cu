// BVH traversal kernels for NVIDIA Hopper (sm_90a): closest-hit and any-hit
// over the unified f32[M,128] record table (row layout: scene/bvh.py).
//
// Replaces the two Pallas TPU kernels of the JAX package,
//   sp_closest  <-  simplepath_tpu/render/pallas_traverse.py::packet_closest
//   sp_anyhit   <-  simplepath_tpu/render/pallas_traverse.py::packet_anyhit
// and computes, ray for ray, what the JAX package's per-ray formulation
// (render/traverse.py::_bvh_closest / _bvh_any) computes: same visit order,
// same slab and Shirley arithmetic, same tie rules.  The plain PyTorch
// versions beside the wrappers (render/cuda_traverse.py: closest_plain,
// anyhit_plain) are the same algorithm with the batch written out.
//
// The BVH topology is a compile-time parameter: -DSP_W=<branching factor>
// -DSP_K=<triangles a leaf>, from scene/bvh.py's WIDTH and LEAF_SIZE (the
// wrapper builds one library per topology, libsp_traverse_w{W}_k{K}.so).
// Covered: W = 8 or 16, 1 <= K <= 32 (render/cuda_traverse.py WIDTHS,
// LEAF_SIZES).  A leaf of 9K + 3 floats spans LEAF_ROWS = ceil((9K+3)/128)
// consecutive rows, which lie back to back in the table, so its flat offsets
// simply run on into the next row (K=24: two rows, meta at float 216).
//
// What bounds it on this card.  Not device memory: the table of a few
// hundred thousand triangles (~16 MB) sits in the 50 MB L2 and a ray moves
// 32 B in and 17 B out, so the byte bound of a 65,536-ray launch is ~6 us.
// A launch is a wavefront of at most 65,536 rays, each a serial chain of
// dependent row visits (6-18 a ray on average at W=8, K=12; 30-60 for the
// longest ray of a wavefront).  A full wavefront is bound by instruction
// rate: the visits' arithmetic, and a warp whose rays stand on rows of both
// kinds runs both branches.  A late bounce, where a few hundred rays still
// live, is bound by its longest chain at well under a microsecond a visit.
//
// What the design does about it: G = W LANES OF ONE WARP SHARE ONE RAY.
//   * A visit's work is spread over the group, so a chain step is short.
//     Internal row: lane c loads the 7 floats of child c (each load of the
//     group is one run of 4W bytes: a 32-byte sector at W=8, 64 bytes at
//     W=16) and does one slab test.  Leaf row: lane c tests triangles c,
//     c + G, ... (TPL = ceil(K/G) slots: at W=8, K=12 triangle c and, for
//     c < 4, 8 + c; at W=16, K=12 one slot and lanes 12-15 idle; at W=8,
//     K=24 three); a log2(G)-step butterfly picks the first minimum.
//   * A warp holds 32/G rays, not 32: it waits for its slowest of 4 (W=8)
//     or 2 (W=16) and runs at most that many different rows a step.
//   * The hit children go on the stack far-to-near WITHOUT running the
//     sorting network: where their keys all differ, a child's slot is the
//     number of keys above its own, which G - 1 independent shuffles give.
//     Only where two hit children have equal keys does the group run the
//     Batcher network (19 compare-exchanges in 6 parallel stages at W=8, 63
//     in 10 at W=16), across lanes, because then the network's order is the
//     one the plain version visits in.
//   * min/max that propagate NaN are one instruction each (min.NaN.f32).
//   * The stack (64 refs a ray at W=8, 96 at W=16: what pack_records holds
//     a tree to) lives in shared memory, 4 KB / 3 KB a block; every lane of
//     a group keeps the ray, sp and the running best in registers.
//   * The loads of a visit depend on nothing but the popped ref: a leaf's
//     triangles are loaded and tested whatever its count says.
//   * A ray whose interval is empty (t_max < t_min: the dead lanes of a late
//     bounce carry t_max = -inf) writes its miss before reading any row.
// Every shuffle, vote and __syncwarp names the group's own G lanes: the
// groups of a warp run the loop independently and leave it at different
// times.  The per-lane arithmetic is the per-ray formulation's, operation
// for operation, so results are bit-equal to the plain version's.
//
// Numerics that pin `idx` to the plain version's (build: -fmad=false, no
// --use_fast_math, IEEE divide):
//   * min/max propagate NaN like torch.minimum/maximum (CUDA's fminf/fmaxf
//     drop it): (lo - ro) * inf is NaN when the origin lies on a box plane
//     and the direction component is zero, and that child must be culled
//     (a NaN only ever fails a comparison, it never becomes a key);
//   * no FMA contraction; operation order of the Shirley test as written in
//     the plain version; one reciprocal and three multiplies;
//   * within a leaf the FIRST minimum wins (smaller t, at equal t the smaller
//     slot: what argmin gives); across leaves an equal-t hit found later does
//     not replace the earlier one (strict <);
//   * children are pushed far-to-near by the ray's own unclamped tnear;
//     equal keys go through the network with the swap rule key[a] < key[b]
//     of the sequential pair list, so they are visited in the same order.
//
// Build (done at first use by render/cuda_traverse.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -DSP_W=8 -DSP_K=12 \
//        -o libsp_traverse_w8_k12.so traverse.cu
// Plain C interface; each entry point launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#if !defined(SP_W) || !defined(SP_K)
#error "build with -DSP_W=<BVH width> -DSP_K=<leaf size> (scene/bvh.py WIDTH, LEAF_SIZE)"
#endif

namespace {

constexpr int W = SP_W;          // BVH branching factor (scene/bvh.py WIDTH)
constexpr int K = SP_K;          // triangles per leaf (LEAF_SIZE)
constexpr int ROW = 128;         // floats per record row (RECORD_WIDTH)
constexpr int G = W;             // lanes of one warp that share a ray
constexpr int BLOCK = 128;       // threads per block
constexpr int MIN_BLOCKS = 8;    // resident blocks per SM the registers must allow
constexpr int RAYS = BLOCK / G;  // rays per block
constexpr int TPL = (K + G - 1) / G;   // leaf slots a lane owns: triangle c + G*p
constexpr int META = 9 * K;      // leaf floats META..META+2: base_lo, base_hi, count
constexpr float NEG_BIG = -3.0e38f;

static_assert(W == 8 || W == 16, "the template covers W = 8 and W = 16");
static_assert(K >= 1 && K <= 32, "the template covers 1 <= K <= 32");
static_assert(BLOCK % 32 == 0 && 32 % G == 0, "groups never straddle a warp");
static_assert(7 * W <= ROW, "an internal row holds W boxes and refs");

// What depends on the width alone: the per-ray stack capacity
// (render/cuda_traverse.py::kernel_stack) and the compare-exchanges of
// batcher_pairs(W), levelled into stages whose pairs touch disjoint elements
// (sort_stages).  Nibble e of a stage's word is the element that element e
// is compared with, or e itself where it rests (sort_stage_partners).  A
// build uses one of the two specialisations; the compiler is told not to
// warn that the other goes unreferenced.
#pragma nv_diag_suppress 177
template <int N> struct Width;

#define SP_SORT_PARTNERS_8 {0x67452301u, 0x54761032u, 0x35607124u, \
                            0x72143650u, 0x76325410u, 0x75634120u}
template <> struct Width<8> {
    static constexpr int STACK = 64;
    static constexpr int SORT_STAGES = 6;
    using Word = unsigned int;
    __device__ static __forceinline__ Word partners(int s) {
        constexpr Word words[SORT_STAGES] = SP_SORT_PARTNERS_8;
        return words[s];
    }
};

#define SP_SORT_PARTNERS_16 {0xefcdab8967452301ull, 0xdcfe98ba54761032ull, \
                             0xbde8f9ac35607124ull, 0x7a9cbed0f2143658ull, \
                             0xfebadc9876325410ull, 0xfdebc9a875634120ull, \
                             0xf65432187edcba90ull, 0xfedc7654ba983210ull, \
                             0xfebadc7698325410ull, 0xfdebc9a785634120ull}
template <> struct Width<16> {
    static constexpr int STACK = 96;
    static constexpr int SORT_STAGES = 10;
    using Word = unsigned long long;
    __device__ static __forceinline__ Word partners(int s) {
        constexpr Word words[SORT_STAGES] = SP_SORT_PARTNERS_16;
        return words[s];
    }
};

#pragma nv_diag_default 177

constexpr int STACK = Width<W>::STACK;   // per-ray stack capacity

__device__ __forceinline__ float pmin(float a, float b) {
    // NaN-propagating minimum (torch.minimum semantics) in one instruction;
    // fminf would return the other operand
    float m;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
    return m;
}

__device__ __forceinline__ float pmax(float a, float b) {
    float m;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
    return m;
}

struct Ray {
    float ox, oy, oz;
    float dx, dy, dz;
    float ix, iy, iz;   // 1/d, IEEE inf for zero components
    float t_min;
};

// Sort the W (key, val) elements of a group, one a lane, descending by key;
// afterwards lane j holds the j-th entry.
__device__ __forceinline__ void sort_children(float& key, int& val, int c,
                                              unsigned gmask) {
    using Net = Width<W>;
#pragma unroll
    for (int s = 0; s < Net::SORT_STAGES; ++s) {
        const int pe = (int)((Net::partners(s) >> (4 * c)) & (G - 1));
        const float okey = __shfl_sync(gmask, key, pe, G);
        const int oval = __shfl_sync(gmask, val, pe, G);
        // the pair (a, b), a < b, swaps when key[a] < key[b]; both of its
        // lanes evaluate that one comparison
        const bool sw = (c < pe) ? (key < okey) : (okey < key);
        key = sw ? okey : key;
        val = sw ? oval : val;
    }
}

// Slab-test the W children of an internal row against the ray, one child a
// lane, and push the hit children far-to-near by unclamped tnear (nearest on
// top).
__device__ __forceinline__ void visit_internal(const float* __restrict__ row,
                                               const Ray& r, float cur_t_max,
                                               int c, unsigned gmask,
                                               int* stack, int& sp) {
    const float* col = row + c;
    const float lox = __ldg(col), loy = __ldg(col + W), loz = __ldg(col + 2 * W);
    const float hix = __ldg(col + 3 * W), hiy = __ldg(col + 4 * W);
    const float hiz = __ldg(col + 5 * W);
    const int cref = (int)__ldg(col + 6 * W);
    const float t0x = (lox - r.ox) * r.ix;
    const float t0y = (loy - r.oy) * r.iy;
    const float t0z = (loz - r.oz) * r.iz;
    const float t1x = (hix - r.ox) * r.ix;
    const float t1y = (hiy - r.oy) * r.iy;
    const float t1z = (hiz - r.oz) * r.iz;
    const float tnear = pmax(pmax(pmin(t0x, t1x), pmin(t0y, t1y)),
                             pmin(t0z, t1z));
    const float tfar = pmin(pmin(pmax(t0x, t1x), pmax(t0y, t1y)),
                            pmax(t0z, t1z));
    const bool hit = (pmax(tnear, r.t_min) <= pmin(tfar, cur_t_max))
                     && (tfar >= r.t_min) && (cref != 0);
    float key = hit ? tnear : -INFINITY;
    int val = cref;
    // Where the hit children's keys all differ, descending order is one
    // order only, and a child's place in it is the number of keys above its
    // own: G - 1 independent shuffles instead of the network's dependent
    // stages.  Equal keys of hit children (rare) take the order the network
    // gives them, so the network runs then.
    int place = 0;
    bool eq = false;
#pragma unroll
    for (int rot = 1; rot < G; ++rot) {
        const float other = __shfl_sync(gmask, key, (c + rot) % G, G);
        place += other > key;
        eq |= other == key;
    }
    const bool tie = eq && (key > NEG_BIG);   // culled children are all -inf
    if (__any_sync(gmask, tie)) {
        sort_children(key, val, c, gmask);
        place = c;
    }
    const int count = __popc(__ballot_sync(gmask, key > NEG_BIG) & gmask);
    // same overflow guard as the plain version (pack_records asserts that
    // the tree fits, so it never triggers on a packed table)
    if (sp > STACK - W) sp = STACK - W;
    if (key > NEG_BIG) stack[sp + place] = val;
    sp += count;
}

// Shirley barycentric test of one leaf triangle (v0, e1 = v0-v1, e2 = v0-v2).
__device__ __forceinline__ bool tri_test(float v0x, float v0y, float v0z,
                                         float A, float B, float C,
                                         float D, float E, float F,
                                         const Ray& r, float cur_t_max,
                                         float& t, float& beta, float& gamma) {
    const float G_ = r.dx, H = r.dy, I = r.dz;
    const float J = v0x - r.ox;
    const float Kk = v0y - r.oy;
    const float L = v0z - r.oz;
    const float EIHF = E * I - H * F;
    const float GFDI = G_ * F - D * I;
    const float DHEG = D * H - E * G_;
    const float denom = A * EIHF + B * GFDI + C * DHEG;
    const float inv = 1.0f / (denom == 0.0f ? 1.0f : denom);
    beta = (J * EIHF + Kk * GFDI + L * DHEG) * inv;
    const float AKJB = A * Kk - J * B;
    const float JCAL = J * C - A * L;
    const float BLKC = B * L - Kk * C;
    gamma = (I * AKJB + H * JCAL + G_ * BLKC) * inv;
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
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
traverse_kernel(const float* __restrict__ records,
                const float* __restrict__ ro, const float* __restrict__ rd,
                const float* __restrict__ t_min, const float* __restrict__ t_max,
                int n,
                float* __restrict__ out_t, int* __restrict__ out_idx,
                float* __restrict__ out_beta, float* __restrict__ out_gamma,
                unsigned char* __restrict__ out_flag) {
    __shared__ int stacks[RAYS][STACK];

    const int group = threadIdx.x / G;
    const int i = blockIdx.x * RAYS + group;
    if (i >= n) return;              // ragged last block: whole groups leave
    const int c = threadIdx.x % G;   // this lane's place in its group
    const unsigned gmask = ((1u << G) - 1u) << ((threadIdx.x % 32) - c);
    int* stack = stacks[group];

    const Ray r = load_ray(ro, rd, t_min, i);
    const float ray_t_max = t_max[i];

    float best_t = INFINITY, best_beta = 0.0f, best_gamma = 0.0f;
    int best_idx = -1;
    bool found = false;

    // an empty interval fails the root's slab tests: miss, no row is read
    int sp = (ray_t_max < r.t_min) ? 0 : 1;
    if (c == 0) stack[0] = 1;        // root ref = +1

    while (sp > 0) {
        __syncwarp(gmask);           // the refs other lanes pushed are visible
        const int ref = stack[--sp];
        const float cur_t_max = ANY ? ray_t_max : fminf(ray_t_max, best_t);
        if (ref > 0) {
            visit_internal(records + (size_t)(ref - 1) * ROW, r, cur_t_max,
                           c, gmask, stack, sp);
            continue;
        }
        // a leaf's LEAF_ROWS rows are consecutive: flat offsets from its
        // first row reach all of them
        const float* row = records + (size_t)(-ref - 1) * ROW;
        int base, count;
        if constexpr (META % 4 == 0) {   // 16-byte aligned (K=12: float 108)
            const float4 meta = __ldg((const float4*)(row + META));
            base = ((int)meta.y << 12) + (int)meta.x;
            count = (int)meta.z;
        } else {
            base = ((int)__ldg(row + META + 1) << 12) + (int)__ldg(row + META);
            count = (int)__ldg(row + META + 2);
        }

        // This lane's first minimum over its own slots (ascending slot
        // order).  Every slot of the row is loaded and tested, whatever the
        // leaf's count (leaves are packed full): the triangle loads then do
        // not wait for the meta load, and `k < count` masks the rest.
        float my_t = INFINITY, my_beta = 0.0f, my_gamma = 0.0f;
        int my_k = c;
        bool any_ok = false;
#pragma unroll
        for (int p = 0; p < TPL; ++p) {
            const int k = c + G * p;
            if (k < K) {
                const float* col = row + k;
                float t, beta, gamma;
                const bool ok = tri_test(__ldg(col), __ldg(col + K), __ldg(col + 2 * K),
                                         __ldg(col + 3 * K), __ldg(col + 4 * K),
                                         __ldg(col + 5 * K), __ldg(col + 6 * K),
                                         __ldg(col + 7 * K), __ldg(col + 8 * K),
                                         r, cur_t_max, t, beta, gamma)
                                && (k < count);
                if (ANY) {
                    any_ok = any_ok || ok;
                } else if (ok && t < my_t) {
                    my_t = t; my_beta = beta; my_gamma = gamma; my_k = k;
                }
            }
        }
        if (ANY) {
            if (__any_sync(gmask, any_ok)) { found = true; break; }
            continue;
        }
        // first minimum of the leaf: smaller t, at equal t the smaller slot
        float win_t = my_t;
        int win_k = my_k;
#pragma unroll
        for (int m = G / 2; m > 0; m >>= 1) {
            const float other_t = __shfl_xor_sync(gmask, win_t, m, G);
            const int other_k = __shfl_xor_sync(gmask, win_k, m, G);
            if (other_t < win_t || (other_t == win_t && other_k < win_k)) {
                win_t = other_t; win_k = other_k;
            }
        }
        // strict <: the earlier of two equal-t hits of different leaves is
        // kept (every lane of the group holds the same win_t and best_t)
        if (win_t < best_t) {
            best_t = win_t;
            best_idx = base + win_k;
            best_beta = __shfl_sync(gmask, my_beta, win_k % G, G);
            best_gamma = __shfl_sync(gmask, my_gamma, win_k % G, G);
            found = true;
        }
    }

    if (c == 0) {
        out_flag[i] = found ? 1 : 0;
        if (!ANY) {
            out_t[i] = best_t;
            out_idx[i] = best_idx;
            out_beta[i] = best_beta;
            out_gamma[i] = best_gamma;
        }
    }
}

template <bool ANY>
int launch(const void* records, const void* ro, const void* rd,
           const void* t_min, const void* t_max, int n,
           void* out_t, void* out_idx, void* out_beta, void* out_gamma,
           void* out_flag, void* stream) {
    if (n > 0) {
        const int grid = (n + RAYS - 1) / RAYS;
        traverse_kernel<ANY><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
            (const float*)records, (const float*)ro, (const float*)rd,
            (const float*)t_min, (const float*)t_max, n,
            (float*)out_t, (int*)out_idx, (float*)out_beta, (float*)out_gamma,
            (unsigned char*)out_flag);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// out_valid / out_occluded: one byte a ray, 0 or 1 (a torch.bool tensor)

extern "C" int sp_closest(const void* records, const void* ro, const void* rd,
                          const void* t_min, const void* t_max, int n,
                          void* out_t, void* out_idx, void* out_beta,
                          void* out_gamma, void* out_valid, void* stream) {
    return launch<false>(records, ro, rd, t_min, t_max, n, out_t, out_idx,
                         out_beta, out_gamma, out_valid, stream);
}

extern "C" int sp_anyhit(const void* records, const void* ro, const void* rd,
                         const void* t_min, const void* t_max, int n,
                         void* out_occluded, void* stream) {
    return launch<true>(records, ro, rd, t_min, t_max, n, nullptr, nullptr,
                        nullptr, nullptr, out_occluded, stream);
}

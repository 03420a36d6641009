// BVH traversal kernels for NVIDIA Hopper (sm_90a): closest-hit and any-hit
// over the unified f32[M,128] record table (row layout: scene/bvh.py).
//
// Replaces the two Pallas TPU kernels of the JAX package,
//   sp_closest  <-  simplepath_tpu/render/pallas_traverse.py::packet_closest
//   sp_anyhit   <-  simplepath_tpu/render/pallas_traverse.py::packet_anyhit
// and the five Pallas kernels of the tools/ probes, as three measuring
// kernels (their wrappers: render/cuda_probes.py; notes at each kernel):
//   sp_closest_count <- tools/prof_visits.py::counting_closest and
//                       tools/prof_npush.py::hist_closest
//   sp_row_chase     <- tools/prof_visits.py::dma_chase and
//                       tools/prof_dma_chains.py::chase
//   sp_visit_body    <- tools/prof_visit_vpu.py::make_kernel
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
// The visit functions take the place a row is read from as a parameter
// (FromTable: the table in device memory through the read-only cache;
// FromShared: a copy in shared memory, for the visit-body probe), so that
// the probes run the traversal's own arithmetic.
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
constexpr int LEAF_ROWS = (META + 3 + ROW - 1) / ROW;   // rows a leaf spans
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
static_assert(STACK >= 2 * W, "a check launch of the visit body scatters 2W entries");

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

// Where a visit reads its row: the table through the read-only cache, or a
// copy of the row in shared memory.
struct FromTable {
    __device__ static __forceinline__ float ld(const float* p) { return __ldg(p); }
};
struct FromShared {
    __device__ static __forceinline__ float ld(const float* p) { return *p; }
};

// Slab test of child c of an internal row against the ray: the child's key
// (the ray's unclamped tnear where the child is hit, -inf where it is not)
// and its ref; `near` / `far` are what the hit test compares (tnear clamped
// to t_min, tfar to cur_t_max).
template <class Mem>
__device__ __forceinline__ float child_key(const float* __restrict__ row,
                                           const Ray& r, float cur_t_max,
                                           int c, int& cref, float& near,
                                           float& far) {
    const float* col = row + c;
    const float lox = Mem::ld(col), loy = Mem::ld(col + W);
    const float loz = Mem::ld(col + 2 * W);
    const float hix = Mem::ld(col + 3 * W), hiy = Mem::ld(col + 4 * W);
    const float hiz = Mem::ld(col + 5 * W);
    cref = (int)Mem::ld(col + 6 * W);
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
    near = pmax(tnear, r.t_min);
    far = pmin(tfar, cur_t_max);
    const bool hit = (near <= far) && (tfar >= r.t_min) && (cref != 0);
    return hit ? tnear : -INFINITY;
}

// The place of this lane's child among the group's hit children, far to
// near (nearest on top of the stack).  Where the hit children's keys all
// differ, descending order is one order only, and a child's place in it is
// the number of keys above its own: G - 1 independent shuffles instead of
// the network's dependent stages.  Equal keys of hit children (rare) take
// the order the network gives them, so the network runs then, and lane j
// holds the j-th entry.
__device__ __forceinline__ int place_children(float& key, int& val, int c,
                                              unsigned gmask) {
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
    return place;
}

// Push the group's hit children at their places; returns n_push, how many
// were hit (the popcount of the group's ballot).
__device__ __forceinline__ int push_children(float key, int val, int place,
                                             unsigned gmask, int* stack,
                                             int& sp) {
    const int count = __popc(__ballot_sync(gmask, key > NEG_BIG) & gmask);
    // same overflow guard as the plain version (pack_records asserts that
    // the tree fits, so it never triggers on a packed table)
    if (sp > STACK - W) sp = STACK - W;
    if (key > NEG_BIG) stack[sp + place] = val;
    sp += count;
    return count;
}

// Slab-test the W children of an internal row against the ray, one child a
// lane, and push the hit children far-to-near by unclamped tnear (nearest on
// top); returns n_push.
template <class Mem>
__device__ __forceinline__ int visit_internal(const float* __restrict__ row,
                                              const Ray& r, float cur_t_max,
                                              int c, unsigned gmask,
                                              int* stack, int& sp) {
    int val;
    float near, far;
    float key = child_key<Mem>(row, r, cur_t_max, c, val, near, far);
    const int place = place_children(key, val, c, gmask);
    return push_children(key, val, place, gmask, stack, sp);
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

// This lane's first minimum over its own slots of a leaf (triangles c,
// c + G, ... in ascending order), `count` of them live.  Every slot of the
// row is loaded and tested, whatever the count (leaves are packed full):
// the triangle loads then do not wait for the meta load, and `k < count`
// masks the rest.  With ANY, returns whether any slot hits.
template <bool ANY, class Mem>
__device__ __forceinline__ bool leaf_slots(const float* __restrict__ row,
                                           const Ray& r, float cur_t_max,
                                           int c, int count, float& my_t,
                                           float& my_beta, float& my_gamma,
                                           int& my_k) {
    bool any_ok = false;
#pragma unroll
    for (int p = 0; p < TPL; ++p) {
        const int k = c + G * p;
        if (k < K) {
            const float* col = row + k;
            float t, beta, gamma;
            const bool ok = tri_test(Mem::ld(col), Mem::ld(col + K),
                                     Mem::ld(col + 2 * K), Mem::ld(col + 3 * K),
                                     Mem::ld(col + 4 * K), Mem::ld(col + 5 * K),
                                     Mem::ld(col + 6 * K), Mem::ld(col + 7 * K),
                                     Mem::ld(col + 8 * K),
                                     r, cur_t_max, t, beta, gamma)
                            && (k < count);
            if (ANY) {
                any_ok = any_ok || ok;
            } else if (ok && t < my_t) {
                my_t = t; my_beta = beta; my_gamma = gamma; my_k = k;
            }
        }
    }
    return any_ok;
}

// First minimum of the group's slots: smaller t, at equal t the smaller
// slot; afterwards every lane of the group holds it.
__device__ __forceinline__ void group_first_min(float& win_t, int& win_k,
                                                unsigned gmask) {
#pragma unroll
    for (int m = G / 2; m > 0; m >>= 1) {
        const float other_t = __shfl_xor_sync(gmask, win_t, m, G);
        const int other_k = __shfl_xor_sync(gmask, win_k, m, G);
        if (other_t < win_t || (other_t == win_t && other_k < win_k)) {
            win_t = other_t; win_k = other_k;
        }
    }
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

// COUNT (sp_closest_count): the closest-hit loop that also counts, per ray,
// its internal visits, its leaf visits and its internal visits by n_push,
// the number of hit children (0, 1, 2, >= 3): what the TPU probes
// tools/prof_visits.py::counting_closest and tools/prof_npush.py::hist_closest
// count per 1,024-ray packet, counted here in the card's unit, the ray.  Every
// lane of a group holds the counts (n_push is the group's ballot); the
// instances without COUNT compile to the code they compiled to before.
template <bool ANY, bool COUNT>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
traverse_kernel(const float* __restrict__ records,
                const float* __restrict__ ro, const float* __restrict__ rd,
                const float* __restrict__ t_min, const float* __restrict__ t_max,
                int n,
                float* __restrict__ out_t, int* __restrict__ out_idx,
                float* __restrict__ out_beta, float* __restrict__ out_gamma,
                unsigned char* __restrict__ out_flag,
                int* __restrict__ out_internal, int* __restrict__ out_leaf,
                int4* __restrict__ out_npush) {
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
    int n_internal = 0, n_leaf = 0;          // COUNT only
    int4 by_push = make_int4(0, 0, 0, 0);

    // an empty interval fails the root's slab tests: miss, no row is read
    int sp = (ray_t_max < r.t_min) ? 0 : 1;
    if (c == 0) stack[0] = 1;        // root ref = +1

    while (sp > 0) {
        __syncwarp(gmask);           // the refs other lanes pushed are visible
        const int ref = stack[--sp];
        const float cur_t_max = ANY ? ray_t_max : fminf(ray_t_max, best_t);
        if (ref > 0) {
            const int n_push = visit_internal<FromTable>(
                records + (size_t)(ref - 1) * ROW, r, cur_t_max, c, gmask,
                stack, sp);
            if constexpr (COUNT) {
                ++n_internal;
                by_push.x += n_push == 0;
                by_push.y += n_push == 1;
                by_push.z += n_push == 2;
                by_push.w += n_push >= 3;
            }
            continue;
        }
        if constexpr (COUNT) ++n_leaf;
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

        float my_t = INFINITY, my_beta = 0.0f, my_gamma = 0.0f;
        int my_k = c;
        const bool any_ok = leaf_slots<ANY, FromTable>(
            row, r, cur_t_max, c, count, my_t, my_beta, my_gamma, my_k);
        if (ANY) {
            if (__any_sync(gmask, any_ok)) { found = true; break; }
            continue;
        }
        float win_t = my_t;
        int win_k = my_k;
        group_first_min(win_t, win_k, gmask);
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
        if constexpr (COUNT) {
            out_internal[i] = n_internal;
            out_leaf[i] = n_leaf;
            out_npush[i] = by_push;
        }
    }
}

template <bool ANY, bool COUNT>
int launch(const void* records, const void* ro, const void* rd,
           const void* t_min, const void* t_max, int n,
           void* out_t, void* out_idx, void* out_beta, void* out_gamma,
           void* out_flag, void* out_internal, void* out_leaf,
           void* out_npush, void* stream) {
    if (n > 0) {
        const int grid = (n + RAYS - 1) / RAYS;
        traverse_kernel<ANY, COUNT><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
            (const float*)records, (const float*)ro, (const float*)rd,
            (const float*)t_min, (const float*)t_max, n,
            (float*)out_t, (int*)out_idx, (float*)out_beta, (float*)out_gamma,
            (unsigned char*)out_flag, (int*)out_internal, (int*)out_leaf,
            (int4*)out_npush);
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- probes
//
// sp_row_chase <- tools/prof_visits.py::dma_chase (one chain) and
// tools/prof_dma_chains.py::chase (C interleaved chains).  A serial pointer
// chase over the table: each hop copies the LEAF_ROWS rows of row |ref| - 1
// into shared memory, reads slot 6W of the copy (an internal row's first
// child ref) and follows it, or restarts chain c at row 1 + c (ref 1 + c)
// where the ref is not positive; after `hops` hops it gives each chain's
// ref.  A ref outside the table is clamped to its last full row (the TPU
// kernel would read past the table).  One warp a launch, every chain's copy
// of a hop issued before any is waited on, as `chase` starts all C DMAs.
// Two feeds, one template (ChaseFeed), the same function:
//   FEED_BULK  the TPU kernel's structure on Hopper: its asynchronous row
//              DMA (pltpu.make_async_copy) and DMA semaphore become one
//              bulk copy by the TMA unit (cp.async.bulk, LEAF_ROWS x 512 B)
//              that completes on an mbarrier; 2C buffers and 2C barriers
//              in shared memory, as the TPU kernel keeps 2C SMEM buffers
//              and 2C semaphores.  Lane 0 issues; every lane waits.  The
//              copy goes through L2 and skips L1.
//   FEED_LDG   the traversal's own row feed: the 32 lanes __ldg the rows
//              through L1, 16 B a lane, into registers, then st.shared.
// What bounds it: the latency of one dependent row copy (a ref is known only
// when the row that holds it has landed); bytes and operations are far
// below it.  So the table sets the reading: over the bench's table the
// chase cycles through the left spine's few rows, which stay in L1 (and
// L2), the latency of a cached row; over cuda_probes.cycle_table, whose
// slot 6W makes one random cycle of every row, each hop copies a row no
// earlier hop of the chain copied, so a table past the 50 MB L2 reads what
// the TPU probe reads: a dependent row copy from device memory (HBM).
enum ChaseFeed { FEED_BULK = 0, FEED_LDG = 1 };

constexpr unsigned CHASE_BYTES = LEAF_ROWS * ROW * 4;   // one copy: LEAF_ROWS x 512 B
static_assert(CHASE_BYTES % 16 == 0, "a bulk copy moves a multiple of 16 B");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// the barrier's current phase completes when this arrival and `bytes` of
// transactions have landed
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// spins until the barrier's phase of this parity has completed; a phase
// that never completes (a byte count or parity gone wrong) traps after
// MBAR_TRIES tries, seconds, so that the launch fails instead of hanging
constexpr unsigned MBAR_TRIES = 1u << 26;

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
    unsigned done = 0;
    for (unsigned tries = 0; !done; ++tries) {
        if (tries == MBAR_TRIES) __trap();
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    }
}

// one bulk copy global -> shared by the TMA unit, completing on `bar`
// (16-B aligned source and destination, a multiple of 16 B)
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes,
                                              unsigned long long* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1], %2, [%3];"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

// orders this thread's generic-proxy accesses to shared memory before later
// async-proxy ones (the next bulk copy into a buffer the lanes have read)
__device__ __forceinline__ void fence_proxy_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ int chase_row(float ref, int n_rows) {
    return max(0, min((int)fabsf(ref) - 1, n_rows - LEAF_ROWS));
}

template <int C, int FEED>
__global__ void __launch_bounds__(32)
row_chase_kernel(const float* __restrict__ records, int n_rows, int hops,
                 float* __restrict__ out_ref) {
    const int lane = threadIdx.x;
    float ref[C];
#pragma unroll
    for (int c = 0; c < C; ++c) ref[c] = 1.0f + c;
    if constexpr (FEED == FEED_BULK) {
        // buffer 2c + p and barrier 2c + p: chain c at hops of parity p
        __shared__ __align__(128) float copies[2 * C][LEAF_ROWS * ROW];
        __shared__ __align__(8) unsigned long long bars[2 * C];
        if (lane == 0) {
#pragma unroll
            for (int b = 0; b < 2 * C; ++b) mbar_init(&bars[b], 1);
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
            fence_proxy_async_smem();
        }
        __syncwarp();
        for (int h = 0; h < hops; ++h) {
            const int p = h & 1;
            if (lane == 0) {                   // every chain's copy in flight
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    unsigned long long* bar = &bars[2 * c + p];
                    mbar_arrive_expect_tx(bar, CHASE_BYTES);
                    bulk_copy_g2s(copies[2 * c + p],
                                  records + (size_t)chase_row(ref[c], n_rows) * ROW,
                                  CHASE_BYTES, bar);
                }
            }
            // the (h >> 1)-th use of each barrier of parity p: its phase
            // of that parity
            const unsigned phase = (unsigned)(h >> 1) & 1u;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                mbar_wait(&bars[2 * c + p], phase);
                const float child = copies[2 * c + p][6 * W];
                ref[c] = child > 0.0f ? child : 1.0f + c;
            }
            // the reads above before the bulk copy that refills these
            // buffers two hops on (a write after a read across proxies)
            fence_proxy_async_smem();
            __syncwarp();
        }
    } else {
        constexpr int V = LEAF_ROWS * ROW / 4;     // float4 a copy: 32 a row
        __shared__ float4 copies[C][V];
        for (int h = 0; h < hops; ++h) {
            float4 v[C][LEAF_ROWS];
#pragma unroll
            for (int c = 0; c < C; ++c) {          // every chain's copy in flight
                const float4* src =
                    (const float4*)(records + (size_t)chase_row(ref[c], n_rows) * ROW);
#pragma unroll
                for (int q = 0; q < LEAF_ROWS; ++q) v[c][q] = __ldg(src + q * 32 + lane);
            }
#pragma unroll
            for (int c = 0; c < C; ++c) {
#pragma unroll
                for (int q = 0; q < LEAF_ROWS; ++q) copies[c][q * 32 + lane] = v[c][q];
            }
            __syncwarp();
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float child = ((const float*)copies[c])[6 * W];
                ref[c] = child > 0.0f ? child : 1.0f + c;
            }
            __syncwarp();                          // before the next copies land
        }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
        if (lane == c) out_ref[c] = ref[c];
}

template <int C>
int launch_chase(const float* records, int n_rows, int hops, int feed,
                 float* out, cudaStream_t s) {
    if (feed == FEED_BULK)
        row_chase_kernel<C, FEED_BULK><<<1, 32, 0, s>>>(records, n_rows, hops, out);
    else if (feed == FEED_LDG)
        row_chase_kernel<C, FEED_LDG><<<1, 32, 0, s>>>(records, n_rows, hops, out);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// sp_visit_body <- tools/prof_visit_vpu.py::make_kernel.  `bodies`
// back-to-back visit bodies on two rows held in shared memory, for the
// probe's fixed ray (origin (0.1 + 1e-6 s, 2, 5), inverse direction
// (3, -7, 2), t_min 1e-3; the seed s picks rows |s| - 1 and |s|), through
// the traversal's own device functions:
//   BODY_INTERNAL  child_key, place_children and push_children: the slab
//                  test of child c on lane c, placement by rank (the network
//                  on equal keys), the ballot and the push;
//   BODY_NOREL     child_key alone: no shuffle, no vote;
//   BODY_SORT      place_children on keys row[c] and refs row[W + c];
//   BODY_LEAF      leaf_slots (the lane's K/G triangle slots, all K live) and
//                  group_first_min (the butterfly).
// The row is read from shared memory anew each body (its address adds a
// zero read from shared memory as volatile, which no compiler pass can fold,
// so no load or arithmetic of a body leaves the loop), and each body's
// result feeds the next one's limit as in the TPU probe.  One float a ray:
// the TPU probe's output value (internal: NaN where a child is not hit;
// leaf: the nearest hit t of row |s|, or inf).  One warp's launch reads the
// latency of a body; a launch that fills every SM reads their throughput.
// What bounds it: instruction issue (the bodies' operations); the rows are
// read from device memory once a block.
// CHECK (a check launch, not timed) also writes what each lane of a ray
// holds after the last body, 4 floats a lane, so that the bodies are held
// against their plain version value by value, not only by the output:
//   BODY_INTERNAL, BODY_SORT  lane j: the key and ref at place j (the
//                  pushed order, nearest last), the count of keys > NEG_BIG
//                  (n_push), 0; places past the count (-inf, 0, count, 0);
//   BODY_NOREL     lane c: child c's key, near, far and ref;
//   BODY_LEAF      lane c: its first minimum's t and slot, and the group's.
enum BodyMode { BODY_INTERNAL = 0, BODY_NOREL = 1, BODY_SORT = 2, BODY_LEAF = 3 };

template <int MODE, bool CHECK>
__global__ void __launch_bounds__(BLOCK)
visit_body_kernel(const float* __restrict__ records, int first_row,
                  float seed, int bodies, int n, float* __restrict__ out,
                  float* __restrict__ lanes) {
    __shared__ float rows[2][LEAF_ROWS * ROW];   // rows |s| - 1 and |s| on
    __shared__ int stacks[RAYS][STACK];
    __shared__ int zero;             // read as volatile: 0, unknown to the compiler
    if (threadIdx.x == 0) zero = 0;
    for (int q = threadIdx.x; q < 2 * LEAF_ROWS * ROW; q += BLOCK) {
        const int b = q / (LEAF_ROWS * ROW);
        rows[b][q - b * LEAF_ROWS * ROW] =
            __ldg(records + (size_t)(first_row + b) * ROW + (q - b * LEAF_ROWS * ROW));
    }
    __syncthreads();

    const int group = threadIdx.x / G;
    const int i = blockIdx.x * RAYS + group;
    if (i >= n) return;
    const int c = threadIdx.x % G;
    const unsigned gmask = ((1u << G) - 1u) << ((threadIdx.x % 32) - c);
    int* stack = stacks[group];

    Ray r;
    r.ox = 0.1f + seed * 1e-6f; r.oy = 2.0f; r.oz = 5.0f;
    r.ix = 3.0f; r.iy = -7.0f; r.iz = 2.0f;
    r.dx = 1.0f / r.ix; r.dy = 1.0f / r.iy; r.dz = 1.0f / r.iz;
    r.t_min = 1e-3f;

    float carry = INFINITY;          // the limit the next body tests against
    float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f, w3 = 0.0f;   // CHECK: the last body's
    int w_place = 0;
    for (int m = 0; m < bodies; ++m) {
        const int z = *(volatile int*)&zero;
        const float* node = rows[0] + z;
        const float* leaf = rows[1] + z;
        if constexpr (MODE == BODY_INTERNAL) {
            int val;
            float near, far;
            float key = child_key<FromShared>(node, r, carry, c, val, near, far);
            const int place = place_children(key, val, c, gmask);
            int sp = 0;
            const int n_push = push_children(key, val, place, gmask, stack, sp);
            carry = carry + key * 0.0f + (float)n_push * 0.0f;
            if constexpr (CHECK) {
                w0 = key; w1 = (float)val; w2 = (float)n_push; w_place = place;
            }
        } else if constexpr (MODE == BODY_NOREL) {
            int val;
            float near, far;
            [[maybe_unused]] const float key =
                child_key<FromShared>(node, r, carry, c, val, near, far);
            carry = carry + (near * 0.0f + far * 0.0f) * 0.0f;
            if constexpr (CHECK) { w0 = key; w1 = near; w2 = far; w3 = (float)val; }
        } else if constexpr (MODE == BODY_SORT) {
            float key = FromShared::ld(node + c);
            int val = __float_as_int(FromShared::ld(node + W + c));
            const int place = place_children(key, val, c, gmask);
            carry = carry + ((place == 0)
                             ? key * 0.0f + __int_as_float(val) * 0.0f : 0.0f);
            if constexpr (CHECK) {
                w0 = key; w1 = __int_as_float(val); w_place = place;
                w2 = (float)__popc(__ballot_sync(gmask, key > NEG_BIG) & gmask);
            }
        } else {
            float my_t = INFINITY, my_beta = 0.0f, my_gamma = 0.0f;
            int my_k = c;
            leaf_slots<false, FromShared>(leaf, r, carry, c, K, my_t, my_beta,
                                          my_gamma, my_k);
            float win_t = my_t;
            int win_k = my_k;
            group_first_min(win_t, win_k, gmask);
            carry = (win_t < carry) ? win_t : carry;
            if constexpr (CHECK) {
                w0 = my_t; w1 = (float)my_k; w2 = win_t; w3 = (float)win_k;
            }
        }
    }
    if constexpr (MODE == BODY_INTERNAL) {   // the pushes are read
        __syncwarp(gmask);
        carry = carry + (float)stack[0] * 0.0f;
    }
    if constexpr (CHECK) {
        if constexpr (MODE == BODY_INTERNAL || MODE == BODY_SORT) {
            // scatter (key, ref) to their places; lane j reads place j
            __syncwarp(gmask);
            if (w0 > NEG_BIG) {
                stack[w_place] = __float_as_int(w0);
                stack[W + w_place] = __float_as_int(w1);
            }
            __syncwarp(gmask);
            const bool live = c < (int)w2;
            w0 = live ? __int_as_float(stack[c]) : -INFINITY;
            w1 = live ? __int_as_float(stack[W + c]) : 0.0f;
        }
        float* lane = lanes + ((size_t)i * G + c) * 4;
        lane[0] = w0; lane[1] = w1; lane[2] = w2; lane[3] = w3;
    }
    // one float a ray: the group's lanes combined, NaN propagating
#pragma unroll
    for (int m = G / 2; m > 0; m >>= 1)
        carry = pmax(carry, __shfl_xor_sync(gmask, carry, m, G));
    if (c == 0) out[i] = carry;
}

template <int MODE>
int launch_body(const void* records, int first_row, float seed, int bodies,
                int n, void* out, void* lanes, void* stream) {
    if (n > 0) {
        const int grid = (n + RAYS - 1) / RAYS;
        const cudaStream_t s = (cudaStream_t)stream;
        const float* rec = (const float*)records;
        if (lanes)
            visit_body_kernel<MODE, true><<<grid, BLOCK, 0, s>>>(
                rec, first_row, seed, bodies, n, (float*)out, (float*)lanes);
        else
            visit_body_kernel<MODE, false><<<grid, BLOCK, 0, s>>>(
                rec, first_row, seed, bodies, n, (float*)out, nullptr);
    }
    return (int)cudaGetLastError();
}

template <int MODE>
int body_blocks_per_sm(int* blocks) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, visit_body_kernel<MODE, false>, BLOCK, 0);
}

}  // namespace

// out_valid / out_occluded: one byte a ray, 0 or 1 (a torch.bool tensor)

extern "C" int sp_closest(const void* records, const void* ro, const void* rd,
                          const void* t_min, const void* t_max, int n,
                          void* out_t, void* out_idx, void* out_beta,
                          void* out_gamma, void* out_valid, void* stream) {
    return launch<false, false>(records, ro, rd, t_min, t_max, n, out_t,
                                out_idx, out_beta, out_gamma, out_valid,
                                nullptr, nullptr, nullptr, stream);
}

extern "C" int sp_anyhit(const void* records, const void* ro, const void* rd,
                         const void* t_min, const void* t_max, int n,
                         void* out_occluded, void* stream) {
    return launch<true, false>(records, ro, rd, t_min, t_max, n, nullptr,
                               nullptr, nullptr, nullptr, out_occluded,
                               nullptr, nullptr, nullptr, stream);
}

// sp_closest's outputs, and per ray: internal visits i32, leaf visits i32,
// internal visits by n_push = 0, 1, 2, >= 3 as i32[4] (16-byte aligned)
extern "C" int sp_closest_count(const void* records, const void* ro,
                                const void* rd, const void* t_min,
                                const void* t_max, int n, void* out_t,
                                void* out_idx, void* out_beta,
                                void* out_gamma, void* out_valid,
                                void* out_internal, void* out_leaf,
                                void* out_npush, void* stream) {
    return launch<false, true>(records, ro, rd, t_min, t_max, n, out_t,
                               out_idx, out_beta, out_gamma, out_valid,
                               out_internal, out_leaf, out_npush, stream);
}

// chains: 1, 2, 4 or 8; feed: ChaseFeed (others of either return
// cudaErrorInvalidValue); out_ref f32[chains]
extern "C" int sp_row_chase(const void* records, int n_rows, int chains,
                            int hops, int feed, void* out_ref, void* stream) {
    const float* rec = (const float*)records;
    float* out = (float*)out_ref;
    cudaStream_t s = (cudaStream_t)stream;
    switch (chains) {
        case 1: return launch_chase<1>(rec, n_rows, hops, feed, out, s);
        case 2: return launch_chase<2>(rec, n_rows, hops, feed, out, s);
        case 4: return launch_chase<4>(rec, n_rows, hops, feed, out, s);
        case 8: return launch_chase<8>(rec, n_rows, hops, feed, out, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// mode: BodyMode; n rays, out f32[n]; lanes f32[n, G, 4] for a check
// launch, else null; rows first_row and first_row + 1 on
// (LEAF_ROWS each) must lie in the table
extern "C" int sp_visit_body(const void* records, int first_row, float seed,
                             int mode, int bodies, int n, void* out,
                             void* lanes, void* stream) {
    switch (mode) {
        case BODY_INTERNAL:
            return launch_body<BODY_INTERNAL>(records, first_row, seed, bodies, n, out, lanes, stream);
        case BODY_NOREL:
            return launch_body<BODY_NOREL>(records, first_row, seed, bodies, n, out, lanes, stream);
        case BODY_SORT:
            return launch_body<BODY_SORT>(records, first_row, seed, bodies, n, out, lanes, stream);
        case BODY_LEAF:
            return launch_body<BODY_LEAF>(records, first_row, seed, bodies, n, out, lanes, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// blocks of sp_closest resident on one SM at once
extern "C" int sp_closest_blocks_per_sm(int* blocks) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, traverse_kernel<false, false>, BLOCK, 0);
}

// blocks of sp_visit_body's mode resident on one SM at once
extern "C" int sp_visit_body_blocks_per_sm(int mode, int* blocks) {
    switch (mode) {
        case BODY_INTERNAL: return body_blocks_per_sm<BODY_INTERNAL>(blocks);
        case BODY_NOREL: return body_blocks_per_sm<BODY_NOREL>(blocks);
        case BODY_SORT: return body_blocks_per_sm<BODY_SORT>(blocks);
        case BODY_LEAF: return body_blocks_per_sm<BODY_LEAF>(blocks);
        default: return (int)cudaErrorInvalidValue;
    }
}

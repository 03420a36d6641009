// Native wide-BVH builder over triangle AABBs.
//
// Host component: replaces the reference's recursive
// pointer-based builder (shapes/BVHAccelerator.h:160-211)
// with an iterative, allocation-light builder that emits packed flattened
// SoA node arrays ready for device upload.  Used for large meshes
// (lucy-class, tens of millions of triangles) where the numpy builder's
// Python-level recursion is the bottleneck; scene/bvh.py keeps a numpy
// fallback.
//
// Topology: TARGET-LEAF-COUNT splits (round 3).  Each node computes its
// descendant leaf budget L = ceil(n / leaf_size), takes k = min(W, L)
// children with near-equal leaf shares, and cuts its range at positions
// PROPORTIONAL to those shares (recursive widest-centroid-axis
// nth_element).  This keeps every leaf ~full: the previous halving cascade
// bottomed out at ranges of ~13, spending an internal row on two 6-7-tri
// leaves (lucy-28.9M measured 4.2M leaves at mean 6.9/12 + 2.1M two-child
// internals; this scheme packs the same mesh into ~2.4M leaves at ~11/12).
// Output layout matches scene/types.py BVHArrays:
//   child_box  [N,W,6]  (lo.xyz, hi.xyz; empty slots inverted)
//   child_meta [N,W,3]  (node, first, count)
// C ABI, called from Python via ctypes.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BuildContext {
    const float* lo;
    const float* hi;
    std::vector<float> centroid;
    std::vector<int32_t> order;
    std::vector<float> child_box;     // [N,W,6]
    std::vector<int32_t> child_meta;  // [N,W,3]
    std::vector<int32_t> prim_order;
    int leaf_size;
    int width;
};

int alloc_node(BuildContext& ctx) {
    const int id = static_cast<int>(ctx.child_meta.size() / (3 * ctx.width));
    for (int w = 0; w < ctx.width; ++w) {
        ctx.child_box.push_back(3.4e38f);
        ctx.child_box.push_back(3.4e38f);
        ctx.child_box.push_back(3.4e38f);
        ctx.child_box.push_back(-3.4e38f);
        ctx.child_box.push_back(-3.4e38f);
        ctx.child_box.push_back(-3.4e38f);
        ctx.child_meta.push_back(-1);
        ctx.child_meta.push_back(0);
        ctx.child_meta.push_back(0);
    }
    return id;
}

void split_at_widest(BuildContext& ctx, int32_t* first, int32_t* mid,
                     int32_t* last) {
    float cmin[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float cmax[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    for (int32_t* p = first; p != last; ++p) {
        const float* c = &ctx.centroid[static_cast<size_t>(*p) * 3];
        for (int k = 0; k < 3; ++k) {
            cmin[k] = std::min(cmin[k], c[k]);
            cmax[k] = std::max(cmax[k], c[k]);
        }
    }
    int axis = 0;
    float best = cmax[0] - cmin[0];
    for (int k = 1; k < 3; ++k) {
        const float e = cmax[k] - cmin[k];
        if (e > best) { best = e; axis = k; }
    }
    std::nth_element(first, mid, last, [&ctx, axis](int32_t a, int32_t b) {
        return ctx.centroid[static_cast<size_t>(a) * 3 + axis]
             < ctx.centroid[static_cast<size_t>(b) * 3 + axis];
    });
}

// Partition [first,last) into k groups whose sizes are proportional to
// near-equal shares of the range's leaf budget L, by recursive
// widest-axis cuts.  Each group's size n_i <= (its leaf share) * leaf_size,
// so descendant leaves stay near-full.
void cut_range(BuildContext& ctx, int32_t* first, int32_t* last,
               int64_t L, int k,
               std::vector<std::pair<int32_t*, int32_t*>>& out) {
    if (k == 1) {
        out.emplace_back(first, last);
        return;
    }
    const int kl = k / 2;
    const int64_t base = L / k, extra = L % k;
    int64_t Ll = static_cast<int64_t>(kl) * base + std::min<int64_t>(kl, extra);
    const int64_t n = last - first;
    int32_t* mid = first + (n * Ll) / L;
    split_at_widest(ctx, first, mid, last);
    cut_range(ctx, first, mid, Ll, kl, out);
    cut_range(ctx, mid, last, L - Ll, k - kl, out);
}

struct WorkItem { int node; int32_t* first; int32_t* last; };

void fill_node(BuildContext& ctx, int node_id, int32_t* first, int32_t* last,
               std::vector<WorkItem>& stack) {
    const int W = ctx.width;
    const int64_t n = last - first;
    const int64_t L = (n + ctx.leaf_size - 1) / ctx.leaf_size;
    const int k = static_cast<int>(std::min<int64_t>(W, L));
    std::vector<std::pair<int32_t*, int32_t*>> groups;
    groups.reserve(k);
    cut_range(ctx, first, last, L, k, groups);

    int w = 0;
    for (size_t i = 0; i < groups.size() && w < W; ++i) {
        int32_t* gfirst = groups[i].first;
        int32_t* glast = groups[i].second;
        if (glast - gfirst <= 0) continue;
        const size_t bbase = (static_cast<size_t>(node_id) * W + w) * 6;
        float blo[3] = {3.4e38f, 3.4e38f, 3.4e38f};
        float bhi[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
        for (int32_t* p = gfirst; p != glast; ++p) {
            const float* l = &ctx.lo[static_cast<size_t>(*p) * 3];
            const float* h = &ctx.hi[static_cast<size_t>(*p) * 3];
            for (int k = 0; k < 3; ++k) {
                blo[k] = std::min(blo[k], l[k]);
                bhi[k] = std::max(bhi[k], h[k]);
            }
        }
        std::memcpy(&ctx.child_box[bbase], blo, sizeof blo);
        std::memcpy(&ctx.child_box[bbase + 3], bhi, sizeof bhi);

        const size_t mbase = (static_cast<size_t>(node_id) * W + w) * 3;
        if (glast - gfirst <= ctx.leaf_size) {
            ctx.child_meta[mbase + 0] = -1;
            ctx.child_meta[mbase + 1] = static_cast<int32_t>(ctx.prim_order.size());
            ctx.child_meta[mbase + 2] = static_cast<int32_t>(glast - gfirst);
            ctx.prim_order.insert(ctx.prim_order.end(), gfirst, glast);
        } else {
            const int cid = alloc_node(ctx);
            ctx.child_meta[mbase + 0] = cid;
            stack.push_back({cid, gfirst, glast});
        }
        ++w;
    }
}

BuildContext* g_last = nullptr;

}  // namespace

extern "C" {

int32_t bvh_build(const float* lo, const float* hi, int32_t n,
                  int32_t leaf_size, int32_t width) {
    delete g_last;
    auto* ctx = new BuildContext();
    g_last = ctx;
    ctx->lo = lo;
    ctx->hi = hi;
    ctx->leaf_size = leaf_size;
    ctx->width = width;
    ctx->centroid.resize(static_cast<size_t>(n) * 3);
    for (size_t i = 0; i < static_cast<size_t>(n) * 3; ++i) {
        ctx->centroid[i] = 0.5f * (lo[i] + hi[i]);
    }
    ctx->order.resize(n);
    for (int32_t i = 0; i < n; ++i) ctx->order[i] = i;
    ctx->prim_order.reserve(n);

    std::vector<WorkItem> stack;
    const int root = alloc_node(*ctx);
    fill_node(*ctx, root, ctx->order.data(), ctx->order.data() + n, stack);
    while (!stack.empty()) {
        WorkItem it = stack.back();
        stack.pop_back();
        fill_node(*ctx, it.node, it.first, it.last, stack);
    }
    return static_cast<int32_t>(ctx->child_meta.size() / (3 * ctx->width));
}

void bvh_copy_out(float* child_box, int32_t* child_meta, int32_t* prim_order) {
    BuildContext* ctx = g_last;
    std::memcpy(child_box, ctx->child_box.data(), ctx->child_box.size() * 4);
    std::memcpy(child_meta, ctx->child_meta.data(), ctx->child_meta.size() * 4);
    std::memcpy(prim_order, ctx->prim_order.data(), ctx->prim_order.size() * 4);
    delete ctx;
    g_last = nullptr;
}

}  // extern "C"

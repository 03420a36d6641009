"""Closest-hit and any-hit queries over a triangle soup, plain PyTorch.

The reference's own acceleration structure, written for this benchmark and
shared with nothing in the program: triangles in Morton order of their box
centres, leaves of ``LEAF`` consecutive triangles, and levels of ``FAN``
consecutive nodes above them up to a few thousand roots.  A query tests
every root, then the children of every box hit, down to the triangles of
the leaves hit, so it visits a superset of what any BVH would.  Boxes are
widened by a relative margin, and a slab test that reads NaN passes, so
rounding in the box test never drops a triangle; what is kept is decided by
the triangle test alone.

The triangle test is the program's own arithmetic (the port's
``cuda_traverse._visit_leaf`` at commit d1155b91: edges v0-v1 and v0-v2,
one reciprocal and three multiplies), so a hit found here has the t, beta
and gamma the program's selection reads.  Of hits at an equal t the lowest
triangle index wins; the program's BVH takes the one it reaches first, so
the two may differ on exact ties only.
"""

from __future__ import annotations

import torch
from torch import Tensor

LEAF = 16
FAN = 16
ROOTS = 2048
MORTON_BITS = 16
# rays a block tests against every root at once: [block, roots, 3] floats
ROOT_TESTS = 1 << 24
PAIR_CHUNK = 1 << 22
_INF = float("inf")


def _spread_bits(x: Tensor) -> Tensor:
    out = torch.zeros_like(x)
    for b in range(MORTON_BITS):
        out |= ((x >> b) & 1) << (3 * b)
    return out


class Accel:
    """The hierarchy over ``v0``, ``v1``, ``v2`` (float32 [T,3], one device)."""

    def __init__(self, v0: Tensor, v1: Tensor, v2: Tensor):
        dev = v0.device
        lo = torch.minimum(torch.minimum(v0, v1), v2)
        hi = torch.maximum(torch.maximum(v0, v1), v2)
        c = (lo + hi) * 0.5
        s_lo, s_hi = c.min(0).values, c.max(0).values
        q = ((c - s_lo) / torch.clamp_min(s_hi - s_lo, 1e-30)
             * ((1 << MORTON_BITS) - 1)).to(torch.int64)
        code = (_spread_bits(q[:, 0]) << 2) | (_spread_bits(q[:, 1]) << 1) \
            | _spread_bits(q[:, 2])
        order = torch.argsort(code, stable=True)
        t = v0.shape[0]
        n_leaf = -(-t // LEAF)
        pad = n_leaf * LEAF - t
        # padded slots point at triangle 0 and are masked out by ``self.real``
        self.tri = torch.cat([order, torch.zeros(pad, dtype=torch.int64, device=dev)])
        self.real = torch.cat([torch.ones(t, dtype=torch.bool, device=dev),
                               torch.zeros(pad, dtype=torch.bool, device=dev)])
        self.v0, self.e1, self.e2 = v0, v0 - v1, v0 - v2
        big = torch.full((pad, 3), _INF, device=dev)
        blo = torch.cat([lo[order], big]).reshape(n_leaf, LEAF, 3).min(1).values
        bhi = torch.cat([hi[order], -big]).reshape(n_leaf, LEAF, 3).max(1).values
        # levels[0] are the leaves; each next level FAN nodes of the one below
        self.levels = [self._widen(blo, bhi)]
        while blo.shape[0] > ROOTS:
            n = -(-blo.shape[0] // FAN)
            p = n * FAN - blo.shape[0]
            blo = torch.cat([blo, torch.full((p, 3), _INF, device=dev)]
                            ).reshape(n, FAN, 3).min(1).values
            bhi = torch.cat([bhi, torch.full((p, 3), -_INF, device=dev)]
                            ).reshape(n, FAN, 3).max(1).values
            self.levels.append(self._widen(blo, bhi))

    @staticmethod
    def _widen(lo: Tensor, hi: Tensor) -> tuple[Tensor, Tensor]:
        m = 1e-5 * torch.maximum(lo.abs(), hi.abs()) + 1e-6
        return lo - m, hi + m

    @staticmethod
    def _slab(lo, hi, ro, inv_d, t_min, t_max) -> Tensor:
        t0 = (lo - ro) * inv_d
        t1 = (hi - ro) * inv_d
        tnear = torch.amax(torch.minimum(t0, t1), -1)
        tfar = torch.amin(torch.maximum(t0, t1), -1)
        nan = torch.isnan(t0).any(-1) | torch.isnan(t1).any(-1)
        return nan | ((tnear <= tfar) & (tfar >= t_min) & (tnear <= t_max))

    def _pairs(self, ro, rd, t_min, t_max) -> tuple[Tensor, Tensor]:
        """(ray, leaf) pairs whose boxes the rays' intervals cross."""
        dev = ro.device
        inv_d = 1.0 / rd
        lo, hi = self.levels[-1]
        hit = self._slab(lo[None], hi[None], ro[:, None], inv_d[:, None],
                         t_min[:, None], t_max[:, None])
        ray, node = hit.nonzero(as_tuple=True)
        del hit
        for level in range(len(self.levels) - 2, -1, -1):
            lo, hi = self.levels[level]
            kr, kn = [], []
            for s in range(0, ray.shape[0], PAIR_CHUNK // FAN):
                r = ray[s:s + PAIR_CHUNK // FAN, None].expand(-1, FAN).reshape(-1)
                c = (node[s:s + PAIR_CHUNK // FAN, None] * FAN
                     + torch.arange(FAN, device=dev)).reshape(-1)
                c_ok = c < lo.shape[0]
                r, c = r[c_ok], c[c_ok]
                keep = self._slab(lo[c], hi[c], ro[r], inv_d[r], t_min[r], t_max[r])
                kr.append(r[keep])
                kn.append(c[keep])
            ray = torch.cat(kr) if kr else ray[:0]
            node = torch.cat(kn) if kn else node[:0]
        return ray, node

    def _tests(self, ray, leaf, ro, rd, t_min, t_max):
        """Triangle tests of every triangle of every (ray, leaf) pair →
        (ray, triangle, t, beta, gamma) of the valid ones."""
        dev = ro.device
        slot = (leaf[:, None] * LEAF + torch.arange(LEAF, device=dev)).reshape(-1)
        r = ray[:, None].expand(-1, LEAF).reshape(-1)
        ok = self.real[slot]
        r, tri = r[ok], self.tri[slot[ok]]
        v0, e1, e2 = self.v0[tri], self.e1[tri], self.e2[tri]
        o, d = ro[r], rd[r]
        A, B, C = e1[:, 0], e1[:, 1], e1[:, 2]
        D, E, F = e2[:, 0], e2[:, 1], e2[:, 2]
        G, H, I = d[:, 0], d[:, 1], d[:, 2]
        J = v0[:, 0] - o[:, 0]
        K = v0[:, 1] - o[:, 1]
        L = v0[:, 2] - o[:, 2]
        EIHF = E * I - H * F
        GFDI = G * F - D * I
        DHEG = D * H - E * G
        denom = A * EIHF + B * GFDI + C * DHEG
        inv = 1.0 / torch.where(denom == 0.0, 1.0, denom)
        beta = (J * EIHF + K * GFDI + L * DHEG) * inv
        AKJB = A * K - J * B
        JCAL = J * C - A * L
        BLKC = B * L - K * C
        gamma = (I * AKJB + H * JCAL + G * BLKC) * inv
        t = -(F * AKJB + E * JCAL + D * BLKC) * inv
        valid = ((denom != 0.0) & (beta > 0.0) & (beta < 1.0)
                 & (gamma > 0.0) & (beta + gamma < 1.0)
                 & (t >= t_min[r]) & (t <= t_max[r]))
        return r[valid], tri[valid], t[valid], beta[valid], gamma[valid]

    def _blocks(self, ro, rd, t_min, t_max):
        block = max(256, ROOT_TESTS // self.levels[-1][0].shape[0])
        for s in range(0, ro.shape[0], block):
            sl = slice(s, s + block)
            b = (ro[sl], rd[sl], t_min[sl], t_max[sl])
            ray, leaf = self._pairs(*b)
            parts = [self._tests(ray[c:c + PAIR_CHUNK // LEAF],
                                 leaf[c:c + PAIR_CHUNK // LEAF], *b)
                     for c in range(0, ray.shape[0], PAIR_CHUNK // LEAF)]
            if not parts:
                empty = torch.zeros(0, device=ro.device)
                parts = [(empty.long(), empty.long(), empty, empty, empty)]
            yield s, [torch.cat(x) for x in zip(*parts)]

    @torch.no_grad()
    def closest(self, ro, rd, t_min, t_max):
        """(t, triangle, beta, gamma, valid), each [N]; misses t = inf, -1."""
        n, dev = ro.shape[0], ro.device
        best_t = torch.full((n,), _INF, device=dev)
        best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
        best_b = torch.zeros(n, device=dev)
        best_g = torch.zeros(n, device=dev)
        for s, (r, tri, t, beta, gamma) in self._blocks(ro, rd, t_min, t_max):
            r = r + s
            tmin = torch.full((n,), _INF, device=dev).scatter_reduce(
                0, r, t, "amin")
            at_min = t == tmin[r]
            big = torch.iinfo(torch.int64).max
            imin = torch.full((n,), big, dtype=torch.int64, device=dev) \
                .scatter_reduce(0, r[at_min], tri[at_min], "amin")
            win = at_min & (tri == imin[r])
            rw = r[win]
            best_t[rw] = t[win]
            best_i[rw] = tri[win]
            best_b[rw] = beta[win]
            best_g[rw] = gamma[win]
        return best_t, best_i, best_b, best_g, best_i >= 0

    @torch.no_grad()
    def anyhit(self, ro, rd, t_min, t_max) -> Tensor:
        found = torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)
        for s, (r, *_rest) in self._blocks(ro, rd, t_min, t_max):
            found[r + s] = True
        return found

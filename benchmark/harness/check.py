"""How ``correct`` is decided: the sampled pixels of the window's frames
against the plain reference's render of the same pixels.

Each pass of the window keeps ``pixels_per_pass`` pixels of its film, drawn
from the seed before the window opens.  Once the window has closed and the
program's scene is freed, the reference renders those pixels under the same
frame keys, and a pixel counts as off where a channel differs by more than
``rel`` of the reference's value plus ``abs``.  The compared number is the
share of the sampled pixels that are off; its limit is the cell's.  A train
cell compares its first steps' losses, gradient and change, and the first
step's own forward radiance of ``pixels`` sampled pixels, the same way.

The reference is a package of the benchmark's directory that the
configuration names under ``"reference"`` (``plainref`` where it names none),
imported by name (``benchmark/`` is on ``sys.path``).  It imports nothing of
the program, and has two entry points:

- ``<package>.scene.build(text, mesh_dir, device)``: the scene of the
  configuration's text, its files read from ``mesh_dir`` (the
  configuration's work directory, where ``bench.prepare`` wrote them) →
  an object with ``width``, ``height`` and ``materials.albedo`` (a float32
  tensor [materials, 3], which a train cell replaces by its leaf);
- ``<package>.render.render_pixels(s, xs, ys, spp, keys, state_dtype)``:
  the radiance [N, 3] of the pixels (``xs``, ``ys``) at ``spp`` samples,
  each under its frame key (``keys`` [N, 2], or one [2] key for all), the
  radiance state in ``state_dtype`` (None: the configuration's precision;
  the control passes a lower one), differentiable in ``materials.albedo``.

The frame keys, the warm pass's key and the pixel plan are the harness's
own (``plainref.core``'s threefry) for every configuration, and are handed
to the program too.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from plainref import core

MAX_PASSES = 1024
DEFAULT_REFERENCE = "plainref"


def reference(cfg: dict):
    """The (scene, render) modules of the configuration's reference."""
    name = cfg.get("reference", DEFAULT_REFERENCE)
    return (importlib.import_module(f"{name}.scene"),
            importlib.import_module(f"{name}.render"))


def sample_plan(seed: int, n_pixels: int, per_pass: int, device) -> torch.Tensor:
    """[MAX_PASSES, per_pass] pixel indices of the frame, pass by pass,
    drawn from the seed."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 17])
    return torch.from_numpy(rng.integers(0, n_pixels, (MAX_PASSES, per_pass))
                            ).to(device)


def frame_keys(seed: int, passes: int, device) -> torch.Tensor:
    """[passes, 2] frame keys: the seed's key folded with the pass index."""
    base = core.prng_key(seed, device)
    return core.fold_in(base.expand(passes, 2),
                        torch.arange(passes, dtype=torch.int64, device=device))


def warm_key(device) -> torch.Tensor:
    """The key of set-up's warm pass, which is no pass of any window."""
    return core.fold_in(core.prng_key(0, device), 0xFFFFFFFF)


def reference_pixels(cfg: dict, mesh_dir: str, spp: int, seed: int,
                     plan: torch.Tensor, passes: int, device,
                     state_dtype=None) -> torch.Tensor:
    """The configuration's reference's radiance [passes * per_pass, 3] of
    the planned pixels of passes 0 .. passes-1."""
    ref_scene, render = reference(cfg)
    s = ref_scene.build(cfg["scene_text"], mesh_dir, device)
    idx = plan[:passes].reshape(-1).to(device)
    keys = frame_keys(seed, passes, device)
    per = plan.shape[1]
    pk = keys[:, None, :].expand(passes, per, 2).reshape(-1, 2)
    xs, ys = idx % s.width, idx // s.width
    out = render.render_pixels(s, xs, ys, spp, pk, state_dtype)
    del s
    return out


def compare(program: torch.Tensor, reference: torch.Tensor, rel: float,
            abs_: float) -> dict:
    """The compared numbers of the program's pixels against the reference's."""
    p, r = program.double().cpu(), reference.double().cpu()
    gap = (p - r).abs()
    off = (gap > rel * r.abs() + abs_).any(dim=-1) | ~torch.isfinite(p).all(dim=-1)
    return dict(pixels_off_share=float(off.double().mean()),
                pixels_compared=int(off.numel()))


# ------------------------------------------------------------ train step

def train_target(seed: int, n_pixels: int, device) -> torch.Tensor:
    """[n_pixels, 3] target radiance in [0, 0.3), made on the device from
    the seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed & 0x7FFFFFFFFFFFFFFF)
    return torch.rand((n_pixels, 3), generator=g, device=device) * 0.3


class FirstRender:
    """While installed, keeps the rows ``pixels`` of the first image that
    ``module.render_rays`` returns (the train step's own forward render of
    the whole frame, one row a pixel); a row the image lacks is kept as NaN,
    which ``compare`` counts as off."""

    def __init__(self, module, pixels: torch.Tensor):
        self.module, self.pixels, self.kept = module, pixels, None

    def __enter__(self):
        self._orig = fn = self.module.render_rays

        def render_rays(*a, **k):
            img = fn(*a, **k)
            if self.kept is None:
                rows = img.detach().reshape(-1, 3)
                have = self.pixels < rows.shape[0]
                self.kept = torch.full((self.pixels.shape[0], 3), float("nan"),
                                       dtype=rows.dtype, device=rows.device)
                self.kept[have] = rows[self.pixels[have]]
            return img
        self.module.render_rays = render_rays
        return self

    def __exit__(self, *exc):
        self.module.render_rays = self._orig


def reference_train(cfg: dict, mesh_dir: str, spp: int, seed: int,
                    target: torch.Tensor, steps: int, lr: float, device,
                    state_dtype=None, block: int = 1 << 18,
                    pixels: torch.Tensor | None = None) -> dict:
    """The configuration's reference's first ``steps`` SGD steps on the
    albedo from the configuration's own: each step's loss (the mean squared
    error of the whole frame against ``target``, under frame key ``t``),
    the first step's gradient, the albedo after the last step, and the first
    step's radiance of the rows ``pixels``.  The frame is rendered and
    differentiated in blocks of ``block`` pixels.  With ``state_dtype``
    (the control) the render's radiance state is held in that precision."""
    ref_scene, render = reference(cfg)
    s = ref_scene.build(cfg["scene_text"], mesh_dir, device)
    n = s.width * s.height
    lin = torch.arange(n, device=device)
    xs, ys = lin % s.width, lin // s.width
    keys = frame_keys(seed, steps, device)
    albedo0 = s.materials.albedo.clone()
    a = albedo0
    losses, grads, first = [], [], []
    for t in range(steps):
        leaf = a.detach().requires_grad_(True)
        s.materials.albedo = leaf
        total = torch.zeros((), dtype=torch.float64, device=device)
        for b0 in range(0, n, block):
            img = render.render_pixels(s, xs[b0:b0 + block], ys[b0:b0 + block],
                                       spp, keys[t], state_dtype)
            if t == 0:
                first.append(img.detach())
            part = ((img - target[b0:b0 + block]) ** 2).sum()
            part.backward()
            total += part.detach().double()
        losses.append(float(total) / (n * 3))
        grads.append(leaf.grad / (n * 3))
        a = (leaf - lr * grads[-1]).detach()
    del s
    first = torch.cat(first)
    return dict(albedo0=albedo0, losses=losses, grad0=grads[0], albedo=a,
                pixels=None if pixels is None else first[pixels.to(first.device)])


def compare_train(program: dict, reference: dict, lr: float, chk: dict) -> dict:
    """The compared numbers of a train cell: the worst step's loss gap, the
    first gradient's norm gap (the program's gradient worked out from its
    state after one step) and the gap of the albedo's change after the
    steps, each over the reference's own value; and the share of the first
    step's sampled pixels that are off, as ``compare`` counts it."""
    gap = lambda p, r: abs(p - r) / max(abs(r), 1e-30)
    a0 = reference["albedo0"].double().cpu()
    g_p = (a0 - program["albedo"][0].double().cpu()) / lr
    d_p = program["albedo"][-1].double().cpu() - a0
    d_r = reference["albedo"].double().cpu() - a0
    return dict(
        loss_gap=max(gap(p, r) for p, r in zip(program["losses"], reference["losses"])),
        grad_norm_gap=gap(float(g_p.norm()), float(reference["grad0"].double().cpu().norm())),
        change_norm_gap=gap(float(d_p.norm()), float(d_r.norm())),
        pixels_off_share=compare(program["pixels"], reference["pixels"], chk["rel"],
                                 chk["abs"])["pixels_off_share"])

"""Differentiable rendering: parameter dict, loss and train step.

Counterpart of ``simplepath_tpu/diff/grad.py`` on torch autograd, with the
same names and parameter keys.  The render is differentiable with respect to
material albedo/roughness/ior, the clearcoat parameters, light radiance, the
environment's radiance and image, and the user-level camera parameters (eye,
look-at, up, fov: the look-at bake runs in the graph).  Discrete decisions
(BVH traversal, hit selection, lobe and layer selection, Russian roulette,
occlusion) are detached, and continuous quantities flow through the winning
branch: the detached-sampling estimator of the JAX package.  The two CUDA
traversal kernels run only on detached rays, so neither needs a backward.

Known non-differentiable corners, as in the JAX package: visibility
boundaries (silhouettes) and the IBL CDF tables (radiance gradients flow
through the radiance lookup, not through the sampling distribution).

The parameters are scene tables, not layers, so this is plain functions over
dicts of tensors.  ``render_rays`` builds the materials' rho table from the
scene's roughness and ior inside the graph on every call, as the JAX package
does, so their gradients also flow through the one-sample-MIS lobe weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch import Tensor

from .. import tracing
from ..render.film import render_rays
from ..scene.types import Scene

__all__ = ["get_params", "set_params", "render_loss", "render_loss_and_grad",
           "make_train_step", "TrainState"]


def get_params(scene: Scene) -> dict[str, Tensor]:
    """The scene's differentiable parameters (its own tensors)."""
    p = {
        "mat_albedo": scene.materials.albedo,
        "mat_roughness": scene.materials.roughness,
        "mat_ior": scene.materials.ior,
        "mat_cc_ior": scene.materials.cc_ior,
        "mat_cc_color": scene.materials.cc_color,
        "cam_eye": scene.camera.eye,
        "cam_to": scene.camera.to,
        "cam_up": scene.camera.up,
        "cam_fov": scene.camera.fov,
    }
    if scene.static.num_sphere_lights > 0:
        p["light_radiance"] = scene.sphere_lights.radiance
    if scene.env is not None:
        p["env_radiance"] = scene.env.radiance
        p["env_image"] = scene.env.image
    return p


def set_params(scene: Scene, params: dict[str, Tensor]) -> Scene:
    """Write a parameter dict back into the scene (``render_rays`` builds
    the rho table from the new materials, in the graph)."""
    materials = dataclasses.replace(
        scene.materials,
        albedo=params["mat_albedo"],
        roughness=params["mat_roughness"],
        ior=params["mat_ior"],
        cc_ior=params["mat_cc_ior"],
        cc_color=params["mat_cc_color"],
    )
    camera = dataclasses.replace(
        scene.camera, eye=params["cam_eye"], to=params["cam_to"],
        up=params["cam_up"], fov=params["cam_fov"])
    sphere_lights = scene.sphere_lights
    if "light_radiance" in params:
        sphere_lights = dataclasses.replace(scene.sphere_lights,
                                            radiance=params["light_radiance"])
    env = scene.env
    if env is not None and "env_radiance" in params:
        env = dataclasses.replace(env, radiance=params["env_radiance"],
                                  image=params["env_image"])
    return dataclasses.replace(scene, materials=materials, camera=camera,
                               sphere_lights=sphere_lights, env=env)


def render_loss(scene: Scene, params: dict[str, Tensor], target_flat: Tensor,
                xs: Tensor, ys: Tensor, spp: int, key: Tensor,
                integrator: str | None = None, device=None) -> Tensor:
    """MSE between a rendered pixel batch and a target, rendered in
    differentiable mode (each bounce checkpointed).  ``device=None``
    means CUDA and raises without one."""
    scene = set_params(scene, params)
    scene = dataclasses.replace(
        scene, static=dataclasses.replace(scene.static, differentiable=True))
    img = render_rays(scene, xs, ys, spp, key, integrator, device=device)
    return torch.mean((img - target_flat.to(img.device)) ** 2)


def render_loss_and_grad(scene: Scene, params: dict[str, Tensor],
                         target_flat: Tensor, xs: Tensor, ys: Tensor,
                         spp: int, key: Tensor, integrator: str | None = None,
                         device=None, leaves=None
                         ) -> tuple[Tensor, dict[str, Tensor]]:
    """(loss, gradient of the loss for every parameter), the pair
    ``jax.value_and_grad(render_loss)`` gives.  A parameter the render does
    not reach gets a zero gradient.  ``leaves`` (default: every key) names
    the parameters to differentiate; only they get a gradient.  While
    tracing is on, the forward is a ``train.forward`` span ending in
    ``wait.forward`` and the gradient a ``train.backward`` span ending in
    ``wait.backward``; the bounces that autograd recomputes open their spans
    inside the latter."""
    names = list(params) if leaves is None else list(leaves)
    inputs = {k: v.detach().requires_grad_(k in names)
              for k, v in params.items()}
    with tracing.span("train.forward"):
        loss = render_loss(scene, inputs, target_flat, xs, ys, spp, key,
                           integrator, device)
        tracing.wait("forward", loss.device)
    with tracing.span("train.backward"):
        grads = torch.autograd.grad(loss, [inputs[k] for k in names],
                                    allow_unused=True)
        tracing.wait("backward", loss.device)
    return loss.detach(), {
        k: torch.zeros_like(inputs[k]) if g is None else g
        for k, g in zip(names, grads)}


class TrainState(NamedTuple):
    params: dict
    loss: Any


def make_train_step(scene: Scene, spp: int, integrator: str | None = None,
                    lr: float = 0.05, device=None, leaves=None):
    """Plain SGD step closure: (params, target_flat, xs, ys, key) →
    (new params, loss), the update ``p - lr * g``.

    ``leaves=None`` updates every parameter, as the JAX package's step does;
    a tuple of keys differentiates and updates only those and passes the
    rest through.  One rate for every leaf suits few scenes.  On the bench
    scene (``chip_smoke.py``'s train phase) a step over every leaf at the
    default rate raises the loss, for two reasons the JAX package shares:
    the camera leaves' gradient has no silhouette term, so a step that
    carries the edge of a bright emitter across pixels is invisible to it;
    and the near-mirror plane's roughness (0.01) gets a correct but steep
    gradient, so one step moves it to ~0.04, far outside its linear range.
    The tested use there is ``leaves=("mat_albedo",)`` at the default
    rate.  While tracing is on, a step is a ``train.step`` span, the update
    a ``train.update`` span inside it."""

    def step(params, target_flat, xs, ys, key):
        with tracing.span("train.step"):
            loss, grads = render_loss_and_grad(scene, params, target_flat, xs,
                                               ys, spp, key, integrator, device,
                                               leaves)
            with tracing.span("train.update"), torch.no_grad():
                new_params = {k: p.detach() - lr * grads[k] if k in grads
                              else p.detach() for k, p in params.items()}
        return new_params, loss

    return step

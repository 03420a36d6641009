"""Port gradients against ``jax.grad`` for the brute-force integrator with
fixed Russian roulette (tolerances and measured errors in
``test_torch_grad.py``)."""

import pytest
import torch

from test_torch_grad import LEAVES, analytic_grads, assert_leaf_close

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grads():
    return analytic_grads("brute_force_iterative_rr")


def test_loss_matches_jax(grads):
    jl, _, tl, _ = grads
    assert tl == pytest.approx(jl, rel=1e-5)


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradient_leaf_matches_jax(grads, leaf):
    _, jg, _, tg = grads
    assert_leaf_close(jg, tg, leaf)

"""Inverse rendering on the port: ``tests/test_inverse.py``'s joint albedo
and light-radiance solve with ``torch.optim.Adam`` (setup and loss in
``test_torch_inverse.py``).  With one sphere light, albedo and radiance are
only identifiable through their product, so the product is what must land
within 10 % of truth (measured on the CPU after 60 steps: loss drop 103x,
product within 1.9 % per channel)."""

import torch

from test_torch_inverse import optimize, problem  # noqa: F401 (fixture)

torch.set_num_threads(1)


def test_inverse_joint_albedo_radiance(problem):
    p_true, loss_fn = problem
    p0 = dict(p_true,
              mat_albedo=torch.full_like(p_true["mat_albedo"], 0.5),
              light_radiance=torch.full_like(p_true["light_radiance"], 5.0))
    params, loss0, lossN = optimize(p0, loss_fn,
                                    ["mat_albedo", "light_radiance"],
                                    steps=60, lr=0.1)
    assert loss0 / max(lossN, 1e-30) >= 10, (loss0, lossN)
    prod = params["mat_albedo"][0] * params["light_radiance"][0]
    prod_true = p_true["mat_albedo"][0] * p_true["light_radiance"][0]
    rel = ((prod - prod_true).abs() / prod_true).max()
    print(f"loss drop {loss0 / lossN:.0f}x, product off by {float(rel.max()):.4f}")
    assert float(rel) < 0.10, f"albedo*radiance off by {rel}"

"""The port's Adan, parse_optimizer and parse_scheduler against the JAX
package's (humangaussian_tpu/train/{adan,optimizers}.py), mirroring the
Adan and optimizer cases of tests/test_observability.py.

Tolerances: the parameters (of order 1) after each of six steps within
1e-6 absolute + 2e-6 relative of optax's, as tests/test_torch_photo.py
holds the trainer's parameters: float32 rounding only (the bias
corrections are computed in double here and in float32 there, torch's
Adam divides in another order, and optax adds the update delta to the
parameter, which the port writes directly); the schedules equal optax's
values at every step, boundaries included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.train.adan import Adan
from humangaussian_torch.train.optimizers import (
    attach_scheduler,
    parse_optimizer,
    parse_scheduler,
)
from humangaussian_tpu.train.adan import adan
from humangaussian_tpu.train.optimizers import (
    parse_optimizer as jax_parse_optimizer,
)
from humangaussian_tpu.train.optimizers import (
    parse_scheduler as jax_parse_scheduler,
)

RTOL, ATOL = 2e-6, 1e-6


def _run_both(jax_opt, torch_opt_fn, steps=6, seed=0, shape=(5, 3)):
    """The same seeded parameters and gradient sequence through the optax
    transformation and the torch optimizer; returns the parameters after
    every step, as numpy pairs."""
    rs = np.random.RandomState(seed)
    p0 = rs.randn(*shape).astype(np.float32)
    grads = [rs.randn(*shape).astype(np.float32) * 3 for _ in range(steps)]
    jp = {"w": jnp.asarray(p0)}
    st = jax_opt.init(jp)
    tp = torch.nn.Parameter(torch.tensor(p0))
    opt = torch_opt_fn([tp])
    out = []
    for g in grads:
        upd, st = jax_opt.update({"w": jnp.asarray(g)}, st, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
        tp.grad = torch.tensor(g)
        opt.step()
        out.append((np.asarray(jp["w"]), tp.detach().numpy().copy()))
    return out


@pytest.mark.parametrize("kwargs", [
    {}, {"weight_decay": 0.01}, {"max_grad_norm": 1.0},
    {"no_prox": True, "weight_decay": 0.01},
    {"weight_decay": 0.02, "max_grad_norm": 0.5},
])
def test_adan_matches_the_jax_transformation(kwargs):
    for want, got in _run_both(
            adan(learning_rate=0.05, **kwargs),
            lambda p: Adan(p, lr=0.05, **kwargs)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_adan_first_step_is_sign_like():
    """At t = 1: diff = 0, m = (1 - b1) g, n = (1 - b3) g^2, so the update
    is -lr g / (|g| + eps)."""
    p = torch.nn.Parameter(torch.tensor([2.0, -3.0, 0.5]))
    g = torch.tensor([0.4, -0.2, 0.1])
    opt = Adan([p], lr=0.1)
    p.grad = g
    opt.step()
    np.testing.assert_allclose((p - torch.tensor([2.0, -3.0, 0.5])).detach(),
                               -0.1 * np.sign(g.numpy()), atol=1e-4)


def test_adan_converges_on_quadratic():
    p = torch.nn.Parameter(torch.tensor([5.0, -4.0]))
    opt = Adan([p], lr=0.05)
    for _ in range(600):
        opt.zero_grad()
        ((p - 1.0) ** 2).sum().backward()
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), 1.0, atol=0.15)


@pytest.mark.parametrize("name,args", [
    ("adam", {"lr": 1e-2}), ("adam", {"lr": 1e-2, "betas": (0.8, 0.99)}),
    ("adamw", {"lr": 1e-2}), ("adamw", {"lr": 1e-2, "weight_decay": 0.1}),
    ("sgd", {"lr": 1e-2}), ("sgd", {"lr": 1e-2, "momentum": 0.9}),
    ("adan", {"lr": 1e-2}), ("adan", {"lr": 1e-2, "max_grad_norm": 1.0}),
])
def test_parse_optimizer_matches_optax(name, args):
    for want, got in _run_both(jax_parse_optimizer(name, **dict(args)),
                               lambda p: parse_optimizer(name, p,
                                                         **dict(args))):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_parse_optimizer_rejects_unknown_names():
    with pytest.raises(ValueError):
        parse_optimizer("lamb", [torch.nn.Parameter(torch.ones(2))])


@pytest.mark.parametrize("name,kw", [
    ("constant", {}), ("linear", {}), ("linear", {"end_lr": 1e-3}),
    ("exponential", {"gamma": 0.1}), ("exponential", {}),
    ("multistep", {"milestones": [10], "gamma": 0.5}),
    ("multistep", {"milestones": [30, 10, 60], "gamma": 0.3}),
    ("multistep", {}),
])
def test_parse_scheduler_equals_optax_at_every_step(name, kw):
    max_steps = 100
    want = jax_parse_scheduler(name, 0.01, max_steps, **kw)
    got = parse_scheduler(name, 0.01, max_steps, **kw)
    for step in range(-2, max_steps + 5):
        assert np.float32(got(step)) == np.float32(want(step)), (name, step)


def test_attach_scheduler_drives_the_learning_rate():
    p = torch.nn.Parameter(torch.ones(3))
    opt = parse_optimizer("sgd", [p], lr=0.01)
    sched = parse_scheduler("multistep", 0.01, 10, milestones=[2, 4],
                            gamma=0.5)
    lrs = attach_scheduler(opt, sched)
    seen = []
    for _ in range(6):
        seen.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(3)
        opt.step()
        lrs.step()
    np.testing.assert_allclose(seen, [sched(s) for s in range(6)],
                               rtol=1e-7)
    assert seen[0] > seen[2] > seen[4]

"""Train-mode BatchNorm of the port (`ops/blocks.BatchNorm`) against flax's
`BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)`, the JAX
package's `batch_norm(train=True)` (tgsr_tpu/ops/blocks.py:116-121), on the
CPU: the output, its gradients, and the running stats after the update,
which blend the *biased* batch variance (torch's own BatchNorm2d blends the
unbiased one; the port follows flax, the package it is held against).

Gates: float32 rtol = atol = 1e-5 (sums over the batch in another order);
bfloat16 input: moments in float32 on both sides, the output within one
bfloat16 step of its magnitude (rtol 2^-7), the stats float32 at 1e-5.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tgsr_tpu_torch.ops.blocks import BatchNorm, batch_norm

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _flax(x_nhwc, scale, bias, mean, var):
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    y, upd = bn.apply(variables, x_nhwc, mutable=["batch_stats"])
    return y, upd["batch_stats"]


def _port(x_nchw, scale, bias, mean, var):
    bn = batch_norm(scale.shape[0])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    return bn.train(), bn(x_nchw)


@pytest.mark.parametrize("shape", [(4, 3, 3, 2), (2, 8, 8, 16), (3, 5, 7, 32)])
def test_train_bn_matches_flax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)  # NHWC, mean away from 0
    c = shape[-1]
    scale, bias = rng.normal(1, 0.2, c).astype(np.float32), rng.normal(0, 0.2, c).astype(np.float32)
    mean, var = rng.normal(0, 0.3, c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    y_ref, stats = _flax(jnp.asarray(x), scale, bias, mean, var)
    bn, y = _port(torch.from_numpy(x).permute(0, 3, 1, 2), scale, bias, mean, var)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), **TOL)
    # flax blends the biased variance: 0.9 var + 0.1 var(ddof=0)
    biased = x.reshape(-1, c).var(0)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * var + 0.1 * biased, rtol=1e-5)


def test_biased_variance_is_not_torchs_rule():
    """On a [4, 3, 3, 2] input from var = 1: the port's running var is
    flax's 0.9 + 0.1 var(ddof=0), not torch's 0.9 + 0.1 var(ddof=1)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 2, 3, 3)).astype(np.float32))
    bn = batch_norm(2).train()
    bn(x)
    flat = x.permute(1, 0, 2, 3).reshape(2, -1)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * flat.var(1, unbiased=False))
    mean, var = torch.zeros(2), torch.ones(2)
    F.batch_norm(x, mean, var, training=True, momentum=0.1)
    assert not torch.allclose(bn.running_var, var, rtol=1e-5, atol=0)
    torch.testing.assert_close(var, 0.9 + 0.1 * flat.var(1, unbiased=True))


def test_train_bn_grads_match_flax():
    rng = np.random.default_rng(5)
    x = rng.normal(0.3, 1.5, (3, 6, 6, 8)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    scale, bias = rng.normal(1, 0.2, 8).astype(np.float32), rng.normal(0, 0.2, 8).astype(np.float32)
    zeros, ones = np.zeros(8, np.float32), np.ones(8, np.float32)

    def loss(x, s, b):
        return jnp.sum(_flax(x, s, b, zeros, ones)[0] * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), scale, bias)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    bn, y = _port(xt, scale, bias, zeros, ones)
    (y * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(ref[1]), **TOL)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(ref[2]), **TOL)


def test_train_bn_bf16_input():
    """bfloat16 in, bfloat16 out, float32 moments and running stats (flax
    promotes its moments to float32 likewise)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(0.5, 2.0, (4, 16, 6, 6)).astype(np.float32)).bfloat16()
    scale, bias = rng.normal(1, 0.2, 16).astype(np.float32), rng.normal(0, 0.2, 16).astype(np.float32)
    zeros, ones = np.zeros(16, np.float32), np.ones(16, np.float32)
    y_ref, stats = _flax(jnp.asarray(x.permute(0, 2, 3, 1).float().numpy(), jnp.bfloat16),
                         jnp.asarray(scale, jnp.bfloat16), jnp.asarray(bias, jnp.bfloat16),
                         zeros, ones)
    bn, y = _port(x, scale, bias, zeros, ones)
    assert y.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    ref = np.asarray(y_ref, np.float32)
    err = np.abs(y.permute(0, 2, 3, 1).float().detach().numpy() - ref)
    assert (err <= 2 ** -7 * np.maximum(1.0, np.abs(ref))).all()
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), **TOL)


def test_eval_bn_is_torchs():
    """Eval mode (every serving path) is nn.BatchNorm2d's, running stats
    untouched."""
    bn = batch_norm(4)
    assert isinstance(bn, BatchNorm) and isinstance(bn, torch.nn.BatchNorm2d)
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    x = torch.randn(2, 4, 5, 5)
    before = bn.running_var.clone()
    y = bn.eval()(x)
    torch.testing.assert_close(y, F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                                               bn.bias, False, 0.1, 1e-5))
    assert torch.equal(bn.running_var, before)

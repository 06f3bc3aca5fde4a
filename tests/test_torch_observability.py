"""utils/observability.py's `profile_trace` and `nan_guard` on the CPU.

`profile_trace` writes `<log_dir>/trace.json`, which `json` loads and
which names the ops run inside the block. `nan_guard` raises where
tgsr_tpu's (`checkify.float_checks`) raises and returns equal outputs where
it returns, case by case: NaNs made by arithmetic, reductions and
transcendental functions; a NaN passed in through ops JAX does and does not
check; float and integer division by zero; Infs that are not from a
division; a clean function returns its output unchanged, gradients
included. The one case where the two part (an integer remainder by zero,
where torch's CPU kernel raises its own error) is held as documented."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.utils.observability import nan_guard as jax_nan_guard
from tgsr_tpu_torch.utils.observability import FloatCheckError, nan_guard, profile_trace

NAN = [1.0, float("nan")]
# name: (jax fn, torch fn, input)
CASES = {
    "float_div_by_zero": (lambda x: x / 0.0, lambda x: x / 0.0, [1.0, 2.0]),
    "zero_over_zero": (lambda x: x / x, lambda x: x / x, [0.0, 1.0]),
    "nan_input_mul": (lambda x: x * 2, lambda x: x * 2, NAN),
    "nan_input_reshape": (lambda x: x.reshape(2, 1), lambda x: x.reshape(2, 1), NAN),
    "nan_input_identity": (lambda x: x, lambda x: x, NAN),
    "nan_input_sum": (lambda x: x.sum(), lambda x: x.sum(), NAN),
    "nan_input_max": (jnp.max, torch.max, NAN),
    "nan_input_where": (lambda x: jnp.where(jnp.isnan(x), 0.0, x),
                        lambda x: torch.where(torch.isnan(x), 0.0, x), NAN),
    "nan_input_slice": (lambda x: x[1:], lambda x: x[1:], NAN),
    "nan_input_concat": (lambda x: jnp.concatenate([x, x]), lambda x: torch.cat([x, x]), NAN),
    "nan_input_cast": (lambda x: x.astype(jnp.float16), lambda x: x.to(torch.float16), NAN),
    "nan_input_relu": (jax.nn.relu, torch.relu, NAN),
    "int_div_by_zero": (lambda x: x // jnp.array([1, 0]), lambda x: x // torch.tensor([1, 0]),
                        [3, 4]),
    "int_div": (lambda x: x // jnp.array([1, 2]), lambda x: x // torch.tensor([1, 2]), [3, 4]),
    "inf_minus_inf": (lambda x: x - x, lambda x: x - x, [float("inf")]),
    "log_negative": (jnp.log, torch.log, [-1.0]),
    "sqrt_negative": (jnp.sqrt, torch.sqrt, [-1.0]),
    "inf_times_zero": (lambda x: x * 0.0, lambda x: x * 0.0, [float("inf")]),
    "log_zero": (jnp.log, torch.log, [0.0]),
    "exp_overflow": (jnp.exp, torch.exp, [1000.0]),
    "matmul_clean": (lambda x: x @ x.T, lambda x: x @ x.T, [[1.0, 2.0], [3.0, 4.0]]),
    "softmax_clean": (jax.nn.softmax, lambda x: torch.softmax(x, -1), [1.0, 2.0, 3.0]),
}


def _run(guard, fn, x):
    try:
        return "ok", np.asarray(guard(fn)(x))
    except Exception as e:  # noqa: BLE001 -- each package raises its own error type
        return "raises", type(e).__name__


@pytest.mark.parametrize("name", sorted(CASES))
def test_nan_guard_matches_jax(name):
    jfn, tfn, x = CASES[name]
    jout = _run(jax_nan_guard, jfn, jnp.asarray(x))
    tout = _run(nan_guard, tfn, torch.tensor(x))
    assert tout[0] == jout[0], (jout, tout)
    if jout[0] == "ok":
        np.testing.assert_array_equal(tout[1].astype(np.float64), jout[1].astype(np.float64))
    else:
        assert tout[1] == "FloatCheckError"


def test_nan_guard_integer_remainder_by_zero():
    """JAX returns a value for an integer remainder by zero (its rem has no
    division check); torch's CPU kernel raises its own ZeroDivisionError."""
    assert _run(jax_nan_guard, lambda x: x % jnp.array([1, 0]), jnp.array([3, 4]))[0] == "ok"
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        nan_guard(lambda x: x % torch.tensor([1, 0]))(torch.tensor([3, 4]))


def test_nan_guard_names_the_first_op_and_keeps_gradients():
    with pytest.raises(FloatCheckError, match="aten.log"):
        nan_guard(lambda x: torch.sqrt(torch.log(x)))(torch.tensor([-1.0]))
    lin = torch.nn.Linear(4, 3)
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(0))

    def step(x):
        loss = torch.tanh(lin(x)).pow(2).mean()
        return loss, torch.autograd.grad(loss, lin.weight)[0]

    want = step(x)
    got = nan_guard(step)(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with torch.no_grad():
        lin.weight[0, 0] = float("nan")
    with pytest.raises(FloatCheckError, match="nan generated by op"):
        nan_guard(step)(x)


def test_profile_trace_writes_a_trace_naming_the_ops(tmp_path):
    x = torch.randn(1, 3, 16, 16)
    w = torch.randn(4, 3, 3, 3)
    with profile_trace(str(tmp_path / "trace")) as path:
        torch.nn.functional.conv2d(x, w).relu().sum()
    assert path == os.path.join(str(tmp_path / "trace"), "trace.json")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"aten::conv2d", "aten::relu", "aten::sum"} <= names

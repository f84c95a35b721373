"""The generic grads of five activations at their boundary inputs, held
against the JAX package on the CPU: relu6, brelu, abs, soft_relu and
hard_sigmoid. jnp.clip splits a tie on a bound 0.5/0.5 between x and the
bound and jnp.abs has a derivative of 1 at +-0; the port's lowerings
(paddle_tpu_torch/ops/math_ops.py `_clip`, `_abs`) give the same, bitwise
(each grad is one product of the mean's 1/n by 0, 0.5, 1 or the slope).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
import paddle_tpu_torch as pt

# the bounds of relu6 (0, 6), brelu (0, 24), soft_relu (+-40), abs (+-0)
# and hard_sigmoid (0.2 x + 0.5 at 0 and 1: x = -2.5, 2.5)
X = np.array([[-1, 0, 0.5, 6, 7, 24, 40, -0.0, 2.5, -2.5]], np.float32)


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census (executor._RECORDED_OPS) gets back the
    op types these runs added, as in tests/test_torch_backward.py."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _x_grad(fluid, act):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[X.shape[1]], dtype="float32",
                              stop_gradient=False)
        loss = fluid.layers.mean(getattr(fluid.layers, act)(x))
        fluid.backward.append_backward(loss)
    scope = fluid.Scope() if fluid is pt else jax_executor.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    y, g = exe.run(main, feed={"x": X}, fetch_list=[loss, "x@GRAD"],
                   scope=scope)
    return np.asarray(y), np.asarray(g)


@pytest.mark.parametrize("act", ["relu6", "brelu", "abs", "soft_relu",
                                 "hard_sigmoid"])
def test_activation_grad_at_bounds_matches_jax(act):
    want_y, want_g = _x_grad(jfluid, act)
    got_y, got_g = _x_grad(pt, act)
    np.testing.assert_array_equal(got_g, want_g)
    np.testing.assert_allclose(got_y, want_y, rtol=1e-6)

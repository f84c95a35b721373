"""Weight-decay regularizers appended per parameter (the port's counterpart
of paddle_tpu/regularizer.py; reference
python/paddle/fluid/regularizer.py:25-197): L2 decay adds coeff * param to
the grad, L1 decay coeff * sign(param)."""

from __future__ import annotations

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._regularization_coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type="sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._regularization_coeff})
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """grad += decay(param) for each regularized parameter (reference
    regularizer.py append_regularization_ops)."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        reg = param.regularizer if param.regularizer is not None \
            else regularization
        if grad is None or reg is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        regularization_term = reg(param, grad, block)
        new_grad = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type="elementwise_add",
                        inputs={"X": [grad], "Y": [regularization_term]},
                        outputs={"Out": [new_grad]})
        params_and_grads.append((param, block.var(new_grad.name)))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer

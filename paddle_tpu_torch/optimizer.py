"""Optimizer classes emitting optimizer ops into the program (the port's
counterpart of paddle_tpu/optimizer.py; reference
python/paddle/fluid/optimizer.py:34 Optimizer, :250 SGD, :276 Momentum,
:361 Adam). The other optimizers and ModelAverage wait for a later slice.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import unique_name
from .framework.framework import Variable
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["SGD", "Momentum", "Adam", "Adagrad", "SGDOptimizer",
           "MomentumOptimizer", "AdamOptimizer", "AdagradOptimizer",
           "Optimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None):
        if learning_rate is None:
            raise ValueError("learning_rate is required")
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_var: Optional[Variable] = None
        # {accumulator name: {parameter name: accumulator var}}
        self._accumulators: Dict[str, Dict[str, Variable]] = defaultdict(dict)
        self.helper: Optional[LayerHelper] = None

    # --- learning rate ------------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_var = self._learning_rate
            return
        if self._learning_rate_var is None:
            from .layers.tensor import create_global_var
            self._learning_rate_var = create_global_var(
                name=unique_name.generate("learning_rate"), shape=[1],
                value=float(self._learning_rate), dtype="float32",
                persistable=True)

    def _global_learning_rate(self):
        return self._learning_rate_var

    def _create_param_lr(self, param_and_grad):
        param_lr = param_and_grad[0].optimize_attr.get("learning_rate", 1.0)
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        from .layers.nn import scale as scale_layer
        return scale_layer(base, scale=float(param_lr))

    # --- accumulators -------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        shape = list(shape or param.shape)
        var = self.helper.create_global_variable(
            name=unique_name.generate(f"{param.name}_{name}"),
            persistable=True, dtype=dtype or param.dtype, shape=shape)
        self.helper.set_variable_initializer(
            var, ConstantInitializer(float(fill_value)))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # --- hooks --------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block):
        pass

    # --- driver -------------------------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        program = loss.block.program
        global_block = program.global_block()
        n_before = len(global_block.ops)
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(global_block,
                                  [p for p, g in parameters_and_grads
                                   if g is not None])
        optimize_ops = []
        for param_and_grad in parameters_and_grads:
            if param_and_grad[1] is None:
                continue
            if param_and_grad[0].trainable:
                optimize_ops.append(
                    self._append_optimize_op(global_block, param_and_grad))
        self._finish_update(global_block)
        # role tag (reference OpRole::kOptimize): inference slicing strips
        # everything this pass appended
        for op in global_block.ops[n_before:]:
            op.desc.attrs.setdefault("op_role", "optimize")
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None) -> Tuple[List, List]:
        """append_backward + clip + regularization + optimizer ops
        (reference optimizer.py Optimizer.minimize)."""
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                       [error_clip_callback])
        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        optimize_ops = self._create_optimization_pass(params_grads, loss,
                                                      startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="sgd",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]]})


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator(self._velocity_acc_str,
                                         param_and_grad[0])
        return block.append_op(
            type="momentum",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdagradOptimizer(Optimizer):
    """Adagrad (reference optimizer.py AdagradOptimizer). It has no sparse
    apply: a SelectedRows grad densifies at its op, counted."""
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        return block.append_op(
            type="adagrad",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon})


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._beta1_pow = None
        self._beta2_pow = None

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
        if self._beta1_pow is None:
            self._beta1_pow = self.helper.create_global_variable(
                name=unique_name.generate("beta1_pow_acc"), persistable=True,
                dtype="float32", shape=[1])
            self.helper.set_variable_initializer(
                self._beta1_pow, ConstantInitializer(self._beta1))
            self._beta2_pow = self.helper.create_global_variable(
                name=unique_name.generate("beta2_pow_acc"), persistable=True,
                dtype="float32", shape=[1])
            self.helper.set_variable_initializer(
                self._beta2_pow, ConstantInitializer(self._beta2))

    def _append_optimize_op(self, block, param_and_grad):
        m1 = self._get_accumulator(self._moment1_acc_str, param_and_grad[0])
        m2 = self._get_accumulator(self._moment2_acc_str, param_and_grad[0])
        return block.append_op(
            type="adam",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [self._beta1_pow],
                    "Beta2Pow": [self._beta2_pow],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "Moment1Out": [m1],
                     "Moment2Out": [m2]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block):
        """Advance the beta^t accumulators (reference optimizer.py Adam
        _finish_update appends scale ops)."""
        block.append_op(type="scale", inputs={"X": [self._beta1_pow]},
                        outputs={"Out": [self._beta1_pow]},
                        attrs={"scale": self._beta1})
        block.append_op(type="scale", inputs={"X": [self._beta2_pow]},
                        outputs={"Out": [self._beta2_pow]},
                        attrs={"scale": self._beta2})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Adagrad = AdagradOptimizer

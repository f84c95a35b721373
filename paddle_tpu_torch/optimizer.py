"""Optimizer classes emitting optimizer ops into the program (the port's
counterpart of paddle_tpu/optimizer.py; reference
python/paddle/fluid/optimizer.py:34 Optimizer, :250 SGD, :276 Momentum,
:320 Adagrad, :361 Adam, :466 Adamax, :550 DecayedAdagrad, :594 Adadelta,
:676 RMSProp, Ftrl, :811 ModelAverage).
"""

from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import unique_name
from .framework.framework import (Program, Variable, default_main_program,
                                  program_guard)
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = [
    "SGD", "Momentum", "Adagrad", "Adam", "Adamax", "DecayedAdagrad",
    "Adadelta", "RMSProp", "Ftrl", "SGDOptimizer", "MomentumOptimizer",
    "AdagradOptimizer", "AdamOptimizer", "AdamaxOptimizer",
    "DecayedAdagradOptimizer", "AdadeltaOptimizer", "RMSPropOptimizer",
    "FtrlOptimizer", "Optimizer", "ModelAverage",
]


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
        from . import telemetry
        telemetry.counter(
            "optimizer_minimize_total",
            "training graphs built (minimize calls), by optimizer type",
            labels=("optimizer",)).labels(
                optimizer=getattr(self, "type", type(self).__name__)).inc()
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


class AdamaxOptimizer(Optimizer):
    """Adamax (reference optimizer.py:466): Adam's second moment replaced
    by an exponentially weighted infinity norm; one Beta1Pow for all
    parameters, advanced by _finish_update."""
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adamax"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._beta1_pow = None

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
        if self._beta1_pow is None:
            self._beta1_pow = self.helper.create_global_variable(
                name=unique_name.generate("beta1_pow_acc"), persistable=True,
                dtype="float32", shape=[1])
            self.helper.set_variable_initializer(
                self._beta1_pow, ConstantInitializer(self._beta1))

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        inf_norm = self._get_accumulator(self._inf_norm_acc_str,
                                         param_and_grad[0])
        return block.append_op(
            type="adamax",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [moment], "InfNorm": [inf_norm],
                    "Beta1Pow": [self._beta1_pow],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment],
                     "InfNormOut": [inf_norm]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block):
        block.append_op(type="scale", inputs={"X": [self._beta1_pow]},
                        outputs={"Out": [self._beta1_pow]},
                        attrs={"scale": self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    """Adagrad whose squared-grad sum decays by `decay` a step (reference
    optimizer.py:550)."""
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    """Adadelta (reference optimizer.py:594); its op applies the raw update
    and reads no learning rate."""
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adadelta"
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        ag = self._get_accumulator(self._avg_squared_grad_acc_str,
                                   param_and_grad[0])
        au = self._get_accumulator(self._avg_squared_update_acc_str,
                                   param_and_grad[0])
        return block.append_op(
            type="adadelta",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "AvgSquaredGrad": [ag], "AvgSquaredUpdate": [au],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "AvgSquaredGradOut": [ag], "AvgSquaredUpdateOut": [au]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    """RMSProp with optional momentum (reference optimizer.py:676)."""
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "rmsprop"
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        mom = self._get_accumulator(self._momentum_acc_str, param_and_grad[0])
        ms = self._get_accumulator(self._mean_square_acc_str,
                                   param_and_grad[0])
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [mom], "MeanSquare": [ms],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [mom],
                     "MeanSquareOut": [ms]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum})


class FtrlOptimizer(Optimizer):
    """FTRL-proximal (reference ftrl_op.cc) with l1/l2 and lr_power."""
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "ftrl"
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        sq = self._get_accumulator(self._squared_acc_str, param_and_grad[0])
        lin = self._get_accumulator(self._linear_acc_str, param_and_grad[0])
        return block.append_op(
            type="ftrl",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer


class ModelAverage(Optimizer):
    """Running averages of the parameters, swapped in for evaluation
    (reference optimizer.py:811, average_accumulates_op.cc).

    Appends an average_accumulates op per parameter to the main program;
    `apply(executor)` is a context manager that replaces each parameter by
    (sum_1 + sum_2 + sum_3) / (num_accumulates + old_num_accumulates),
    keeping the trained value in `<param>@MODEL_AVG_BACKUP`, and restores
    it on exit (or through `restore`). The swaps are programs of their own,
    run by the executor like any other."""

    def __init__(self, average_window_rate, params_grads=None,
                 min_average_window=10000, max_average_window=10000,
                 **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = params_grads or [
            (p, None) for p in
            default_main_program().global_block().all_parameters()]
        self.helper = LayerHelper(self.__class__.__name__)
        self._avg_params = []
        for param, _ in self.params_grads:
            self._append_average_accumulate_op(param)
            self._avg_params.append(param)

    def _append_average_accumulate_op(self, param):
        sum_1 = self._add_accumulator("sum_1", param)
        sum_2 = self._add_accumulator("sum_2", param)
        sum_3 = self._add_accumulator("sum_3", param)
        num_acc = self._add_accumulator("num_accumulates", param,
                                        dtype="int32", shape=[1])
        old_num = self._add_accumulator("old_num_accumulates", param,
                                        dtype="int32", shape=[1])
        num_upd = self._add_accumulator("num_updates", param,
                                        dtype="int32", shape=[1])
        default_main_program().global_block().append_op(
            type="average_accumulates",
            inputs={"param": [param], "in_sum_1": [sum_1],
                    "in_sum_2": [sum_2], "in_sum_3": [sum_3],
                    "in_num_accumulates": [num_acc],
                    "in_old_num_accumulates": [old_num],
                    "in_num_updates": [num_upd]},
            outputs={"out_sum_1": [sum_1], "out_sum_2": [sum_2],
                     "out_sum_3": [sum_3],
                     "out_num_accumulates": [num_acc],
                     "out_old_num_accumulates": [old_num],
                     "out_num_updates": [num_upd]},
            attrs={"average_window": float(self.average_window),
                   "min_average_window": int(self.min_average_window),
                   "max_average_window": int(self.max_average_window)})

    def _swap_program(self, restore):
        from .layers import nn as nl
        from .layers import tensor as tl
        prog = Program()
        with program_guard(prog, Program()):
            block = prog.global_block()
            for param, _ in self.params_grads:
                p = block.create_var(name=param.name, shape=param.shape,
                                     dtype=param.dtype, persistable=True)
                backup = block.create_var(
                    name=param.name + "@MODEL_AVG_BACKUP",
                    shape=param.shape, dtype=param.dtype, persistable=True)
                if restore:
                    tl.assign(backup, output=p)
                    continue
                acc = {k: self._ref(block, self._get_accumulator(k, param))
                       for k in ("sum_1", "sum_2", "sum_3", "num_accumulates",
                                 "old_num_accumulates")}
                tl.assign(p, output=backup)
                total = nl.elementwise_add(
                    nl.elementwise_add(acc["sum_1"], acc["sum_2"]),
                    acc["sum_3"])
                cnt = tl.cast(nl.elementwise_add(
                    acc["num_accumulates"], acc["old_num_accumulates"]),
                    "float32")
                cnt = nl.elementwise_max(
                    cnt, tl.fill_constant(shape=[1], dtype="float32",
                                          value=1.0))
                tl.assign(nl.elementwise_div(total, cnt, axis=0), output=p)
        return prog

    @staticmethod
    def _ref(block, var):
        return block.create_var(name=var.name, shape=var.shape,
                                dtype=var.dtype, persistable=True)

    @contextmanager
    def apply(self, executor, need_restore=True):
        """The averaged parameters swapped in for the `with` body
        (reference optimizer.py:885)."""
        executor.run(self._swap_program(restore=False))
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor):
        """The trained parameters back from their backups."""
        executor.run(self._swap_program(restore=True))

"""Optimizers (counterpart of ``paddle_tpu/fluid/optimizer.py``): the
``Optimizer`` base, SGD, Momentum, Adagrad, Adam, Adamax, DecayedAdagrad,
Adadelta, RMSProp, Ftrl, ProximalGD, ProximalAdagrad, and ModelAverage.

``minimize`` appends the backward pass, gradient clipping, regularization and
one update op per parameter to the main program, with the accumulators and
the learning-rate var named as in the JAX package (``<param>_velocity_0``,
``<param>_moment1_0``, ``beta1_pow_acc_0``, ``learning_rate_0``) and
initialized in the startup program.  A learning rate may be a float or a
Variable (a schedule of ``layers.learning_rate_scheduler``).
"""

from collections import defaultdict
from contextlib import contextmanager

from . import framework
from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import Variable
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = [
    'SGD', 'Momentum', 'Adagrad', 'Adam', 'Adamax', 'DecayedAdagrad',
    'Ftrl', 'SGDOptimizer', 'MomentumOptimizer', 'AdagradOptimizer',
    'AdamOptimizer', 'AdamaxOptimizer', 'DecayedAdagradOptimizer',
    'RMSPropOptimizer', 'FtrlOptimizer', 'Adadelta', 'AdadeltaOptimizer',
    'ModelAverage', 'Optimizer', 'ProximalGD', 'ProximalGDOptimizer',
    'ProximalAdagrad', 'ProximalAdagradOptimizer',
]


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None, name=None):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError('learning rate should be float or Variable')
        self._name = name
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map = dict()
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[
                framework.default_main_program()] = self._learning_rate
        # {accum_name: {param_name: accum_var}}
        self._accumulators = defaultdict(lambda: dict())
        self.helper = None

    def _create_global_learning_rate(self):
        lr = self._global_learning_rate()
        if isinstance(lr, Variable):
            return
        if not isinstance(self._learning_rate, float):
            raise TypeError('learning rate should be float or Variable')
        from .layers import tensor
        self._learning_rate_map[framework.default_main_program()] = \
            tensor.create_global_var(
                name=unique_name.generate('learning_rate'),
                shape=[1],
                value=float(self._learning_rate),
                dtype='float32',
                persistable=True)

    def _global_learning_rate(self, program=None):
        if program is None:
            program = framework.default_main_program()
        return self._learning_rate_map.get(program, None)

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError()

    def _create_param_lr(self, param_and_grad):
        param_lr = param_and_grad[0].optimize_attr['learning_rate']
        if param_lr == 1.0:
            return self._global_learning_rate()
        from .layers import ops as _ops
        with framework.program_guard(framework.default_main_program(), None):
            return _ops.scale(self._global_learning_rate(), scale=param_lr)

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block):
        pass

    def _add_accumulator(self,
                         name,
                         param,
                         dtype=None,
                         fill_value=0.0,
                         shape=None):
        if self._name is not None:
            name = self._name + '_' + name
        if name in self._accumulators and \
                param.name in self._accumulators[name]:
            raise Exception('Accumulator %s already exists for parameter %s' %
                            (name, param.name))
        if shape is None:
            shape = param.shape
        assert self.helper is not None
        var_name = unique_name.generate(param.name + '_' + name)
        var = self.helper.create_global_variable(
            name=var_name,
            persistable=True,
            dtype=dtype or param.dtype,
            shape=shape)
        # record the owning param so placement passes (e.g. the sparse
        # DistributeTranspiler rewrite) can co-locate accumulators with
        # their param without guessing from names
        var._accumulator_for = param.name
        self.helper.set_variable_initializer(
            var, initializer=Constant(value=float(fill_value)))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        if self._name is not None:
            name = self._name + '_' + name
        if name not in self._accumulators or \
                param.name not in self._accumulators[name]:
            raise Exception('Accumulator %s does not exist for parameter %s' %
                            (name, param.name))
        return self._accumulators[name][param.name]

    def _create_optimization_pass(self,
                                  parameters_and_grads,
                                  loss,
                                  startup_program=None):
        program = loss.block.program
        with framework.program_guard(program, startup_program):
            global_block = program.global_block()
            optimize_ops = []
            self.helper = LayerHelper(self.__class__.__name__)
            self._create_accumulators(
                global_block, [p[0] for p in parameters_and_grads])
            self._create_global_learning_rate()
            for param_and_grad in parameters_and_grads:
                if param_and_grad[1] is None:
                    continue
                if param_and_grad[0].trainable:
                    optimize_op = self._append_optimize_op(
                        global_block, param_and_grad)
                    optimize_ops.append(optimize_op)
            self._finish_update(global_block)
        return optimize_ops

    def minimize(self,
                 loss,
                 startup_program=None,
                 parameter_list=None,
                 no_grad_set=None):
        """backward + regularization/clip + update ops
        (reference optimizer.py:253)."""
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                       [error_clip_callback])
        with framework.program_guard(loss.block.program, startup_program):
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
        optimize_ops = self._create_optimization_pass(params_grads, loss,
                                                      startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super(SGDOptimizer, self).__init__(
            learning_rate=learning_rate, **kwargs)
        self.type = 'sgd'

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type=self.type,
            inputs={
                'Param': [param_and_grad[0]],
                'Grad': [param_and_grad[1]],
                'LearningRate': [self._create_param_lr(param_and_grad)]
            },
            outputs={'ParamOut': [param_and_grad[0]]})


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = 'velocity'

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super(MomentumOptimizer, self).__init__(
            learning_rate=learning_rate, **kwargs)
        self.type = 'momentum'
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity_acc = self._get_accumulator(self._velocity_acc_str,
                                             param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={
                'Param': [param_and_grad[0]],
                'Grad': [param_and_grad[1]],
                'Velocity': [velocity_acc],
                'LearningRate': [self._create_param_lr(param_and_grad)]
            },
            outputs={
                'ParamOut': [param_and_grad[0]],
                'VelocityOut': [velocity_acc]
            },
            attrs={'mu': self._momentum,
                   'use_nesterov': self._use_nesterov})


class AdamOptimizer(Optimizer):
    _moment1_acc_str = 'moment1'
    _moment2_acc_str = 'moment2'

    def __init__(self,
                 learning_rate=0.001,
                 beta1=0.9,
                 beta2=0.999,
                 epsilon=1e-8,
                 **kwargs):
        super(AdamOptimizer, self).__init__(
            learning_rate=learning_rate, **kwargs)
        self.type = 'adam'
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        main_block = block.program.global_block()
        self._beta1_pow_acc = self.helper.create_global_variable(
            name=unique_name.generate('beta1_pow_acc'),
            dtype='float32',
            shape=[1],
            persistable=True)
        self.helper.set_variable_initializer(
            self._beta1_pow_acc, initializer=Constant(self._beta1))
        self._beta2_pow_acc = self.helper.create_global_variable(
            name=unique_name.generate('beta2_pow_acc'),
            dtype='float32',
            shape=[1],
            persistable=True)
        self.helper.set_variable_initializer(
            self._beta2_pow_acc, initializer=Constant(self._beta2))
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment1 = self._get_accumulator(self._moment1_acc_str,
                                        param_and_grad[0])
        moment2 = self._get_accumulator(self._moment2_acc_str,
                                        param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={
                'Param': [param_and_grad[0]],
                'Grad': [param_and_grad[1]],
                'LearningRate': [self._create_param_lr(param_and_grad)],
                'Moment1': [moment1],
                'Moment2': [moment2],
                'Beta1Pow': [self._beta1_pow_acc],
                'Beta2Pow': [self._beta2_pow_acc]
            },
            outputs={
                'ParamOut': [param_and_grad[0]],
                'Moment1Out': [moment1],
                'Moment2Out': [moment2]
            },
            attrs={
                'beta1': self._beta1,
                'beta2': self._beta2,
                'epsilon': self._epsilon
            })

    def _finish_update(self, block):
        """beta_pow *= beta, once per step (reference optimizer.py Adam)."""
        for acc, beta in ((self._beta1_pow_acc, self._beta1),
                          (self._beta2_pow_acc, self._beta2)):
            block.append_op(
                type='scale',
                inputs={'X': [acc]},
                outputs={'Out': [acc]},
                attrs={'scale': beta})


class AdagradOptimizer(Optimizer):
    _moment_acc_str = 'moment'

    def __init__(self, learning_rate, epsilon=1.0e-6, **kwargs):
        super(AdagradOptimizer, self).__init__(
            learning_rate=learning_rate, **kwargs)
        self.type = 'adagrad'
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={
                'Param': [param_and_grad[0]],
                'Grad': [param_and_grad[1]],
                'Moment': [moment_acc],
                'LearningRate': [self._create_param_lr(param_and_grad)]
            },
            outputs={
                'ParamOut': [param_and_grad[0]],
                'MomentOut': [moment_acc]
            },
            attrs={'epsilon': self._epsilon})


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = 'moment'
    _inf_norm_acc_str = 'inf_norm'

    def __init__(self,
                 learning_rate=0.001,
                 beta1=0.9,
                 beta2=0.999,
                 epsilon=1e-8,
                 **kwargs):
        super(AdamaxOptimizer, self).__init__(
            learning_rate=learning_rate, **kwargs)
        self.type = 'adamax'
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        self._beta1_pow_acc = self.helper.create_global_variable(
            name=unique_name.generate('beta1_pow_acc'),
            dtype='float32',
            shape=[1],
            persistable=True)
        self.helper.set_variable_initializer(
            self._beta1_pow_acc, initializer=Constant(self._beta1))
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        inf_norm = self._get_accumulator(self._inf_norm_acc_str,
                                         param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={
                'Param': [param_and_grad[0]],
                'Grad': [param_and_grad[1]],
                'LearningRate': [self._create_param_lr(param_and_grad)],
                'Moment': [moment],
                'InfNorm': [inf_norm],
                'Beta1Pow': [self._beta1_pow_acc]
            },
            outputs={
                'ParamOut': [param_and_grad[0]],
                'MomentOut': [moment],
                'InfNormOut': [inf_norm]
            },
            attrs={
                'beta1': self._beta1,
                'beta2': self._beta2,
                'epsilon': self._epsilon
            })

    def _finish_update(self, block):
        block.append_op(
            type='scale',
            inputs={'X': [self._beta1_pow_acc]},
            outputs={'Out': [self._beta1_pow_acc]},
            attrs={'scale': self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = 'moment'

    def __init__(self, learning_rate, decay=0.95, epsilon=1.0e-6, **kwargs):
        super(DecayedAdagradOptimizer, self).__init__(
            learning_rate=learning_rate, **kwargs)
        self.type = 'decayed_adagrad'
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={
                'Param': [param_and_grad[0]],
                'Grad': [param_and_grad[1]],
                'Moment': [moment_acc],
                'LearningRate': [self._create_param_lr(param_and_grad)]
            },
            outputs={
                'ParamOut': [param_and_grad[0]],
                'MomentOut': [moment_acc]
            },
            attrs={'epsilon': self._epsilon,
                   'decay': self._decay})


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = '_avg_squared_grad'
    _avg_squared_update_acc_str = '_avg_squared_update'

    def __init__(self, learning_rate, epsilon=1.0e-6, rho=0.95, **kwargs):
        super(AdadeltaOptimizer, self).__init__(
            learning_rate=learning_rate, **kwargs)
        self.type = 'adadelta'
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        avg_squared_grad_acc = self._get_accumulator(
            self._avg_squared_grad_acc_str, param_and_grad[0])
        avg_squared_update_acc = self._get_accumulator(
            self._avg_squared_update_acc_str, param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={
                'Param': [param_and_grad[0]],
                'Grad': [param_and_grad[1]],
                'AvgSquaredGrad': [avg_squared_grad_acc],
                'AvgSquaredUpdate': [avg_squared_update_acc]
            },
            outputs={
                'ParamOut': [param_and_grad[0]],
                'AvgSquaredGradOut': [avg_squared_grad_acc],
                'AvgSquaredUpdateOut': [avg_squared_update_acc]
            },
            attrs={'epsilon': self._epsilon,
                   'rho': self._rho})


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = 'momentum'
    _mean_square_acc_str = 'mean_square'

    def __init__(self,
                 learning_rate,
                 rho=0.95,
                 epsilon=1.0e-6,
                 momentum=0.0,
                 **kwargs):
        super(RMSPropOptimizer, self).__init__(
            learning_rate=learning_rate, **kwargs)
        self.type = 'rmsprop'
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        momentum_acc = self._get_accumulator(self._momentum_acc_str,
                                             param_and_grad[0])
        mean_square_acc = self._get_accumulator(self._mean_square_acc_str,
                                                param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={
                'Param': [param_and_grad[0]],
                'Grad': [param_and_grad[1]],
                'Moment': [momentum_acc],
                'MeanSquare': [mean_square_acc],
                'LearningRate': [self._create_param_lr(param_and_grad)]
            },
            outputs={
                'ParamOut': [param_and_grad[0]],
                'MomentOut': [momentum_acc],
                'MeanSquareOut': [mean_square_acc]
            },
            attrs={
                'epsilon': self._epsilon,
                'decay': self._rho,
                'momentum': self._momentum
            })


class FtrlOptimizer(Optimizer):
    _squared_acc_str = 'squared'
    _linear_acc_str = 'linear'

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super(FtrlOptimizer, self).__init__(
            learning_rate=learning_rate, **kwargs)
        self.type = 'ftrl'
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        squared_acc = self._get_accumulator(self._squared_acc_str,
                                            param_and_grad[0])
        linear_acc = self._get_accumulator(self._linear_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={
                'Param': [param_and_grad[0]],
                'Grad': [param_and_grad[1]],
                'SquaredAccumulator': [squared_acc],
                'LinearAccumulator': [linear_acc],
                'LearningRate': [self._create_param_lr(param_and_grad)]
            },
            outputs={
                'ParamOut': [param_and_grad[0]],
                'SquaredAccumOut': [squared_acc],
                'LinearAccumOut': [linear_acc]
            },
            attrs={
                'l1': self._l1,
                'l2': self._l2,
                'lr_power': self._lr_power
            })


class ProximalGDOptimizer(Optimizer):
    """Proximal gradient descent with L1/L2 shrinkage (reference
    operators/proximal_gd_op.cc)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kwargs):
        super(ProximalGDOptimizer, self).__init__(
            learning_rate=learning_rate, **kwargs)
        self.type = 'proximal_gd'
        self._l1 = l1
        self._l2 = l2

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type=self.type,
            inputs={
                'Param': [param_and_grad[0]],
                'Grad': [param_and_grad[1]],
                'LearningRate': [self._create_param_lr(param_and_grad)]
            },
            outputs={'ParamOut': [param_and_grad[0]]},
            attrs={'l1': self._l1,
                   'l2': self._l2})


class ProximalAdagradOptimizer(Optimizer):
    """Adagrad with proximal L1/L2 shrinkage (reference
    operators/proximal_adagrad_op.cc)."""
    _moment_acc_str = 'moment'

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kwargs):
        super(ProximalAdagradOptimizer, self).__init__(
            learning_rate=learning_rate, **kwargs)
        self.type = 'proximal_adagrad'
        self._l1 = l1
        self._l2 = l2

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str,
                                           param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={
                'Param': [param_and_grad[0]],
                'Grad': [param_and_grad[1]],
                'Moment': [moment_acc],
                'LearningRate': [self._create_param_lr(param_and_grad)]
            },
            outputs={'ParamOut': [param_and_grad[0]],
                     'MomentOut': [moment_acc]},
            attrs={'l1': self._l1,
                   'l2': self._l2})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
ProximalGD = ProximalGDOptimizer
ProximalAdagrad = ProximalAdagradOptimizer


class ModelAverage(Optimizer):
    """Running average of the parameters (reference optimizer.py:1145 and
    its average_accumulates op).  Made after the training optimizer's
    ``minimize``: it appends one ``average_accumulates`` op a parameter to
    the main program.  ``with model_average.apply(exe):`` runs a program
    that backs each parameter up and assigns it its windowed average, and
    ``restore(exe)`` one that assigns the backup back.  Both run through
    the caller's executor over its scope; on the card the parameters'
    scope tensors are the training graph's state buffers, so they are
    written in place and the next replay of the training step reads the
    restored values."""

    def __init__(self,
                 average_window_rate,
                 min_average_window=10000,
                 max_average_window=10000,
                 **kwargs):
        super(ModelAverage, self).__init__(learning_rate=0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params = [
            p for p in
            framework.default_main_program().global_block()
            .all_parameters() if p.trainable
        ]
        self.helper = LayerHelper('model_average')
        with framework.program_guard(framework.default_main_program(),
                                     framework.default_startup_program()):
            for param in self.params:
                self._append_average_accumulate_op(param)

        self.apply_program = framework.Program()
        self.restore_program = framework.Program()
        with framework.program_guard(self.apply_program):
            for param in self.params:
                self._add_average_apply_op(param)
        with framework.program_guard(self.restore_program):
            for param in self.params:
                self._add_average_restore_op(param)

    def _append_average_accumulate_op(self, param):
        self._add_accumulator('sum_1', param)
        self._add_accumulator('sum_2', param)
        self._add_accumulator('sum_3', param)
        self._add_accumulator('num_accumulates', param, dtype='int64',
                              shape=[1])
        self._add_accumulator('old_num_accumulates', param, dtype='int64',
                              shape=[1])
        self._add_accumulator('num_updates', param, dtype='int64',
                              shape=[1])
        accs = {n: self._get_accumulator(n, param) for n in
                ('sum_1', 'sum_2', 'sum_3', 'num_accumulates',
                 'old_num_accumulates', 'num_updates')}
        self.helper.append_op(
            type='average_accumulates',
            inputs={
                'param': [param],
                'in_sum_1': [accs['sum_1']],
                'in_sum_2': [accs['sum_2']],
                'in_sum_3': [accs['sum_3']],
                'in_num_accumulates': [accs['num_accumulates']],
                'in_old_num_accumulates': [accs['old_num_accumulates']],
                'in_num_updates': [accs['num_updates']],
            },
            outputs={
                'out_sum_1': [accs['sum_1']],
                'out_sum_2': [accs['sum_2']],
                'out_sum_3': [accs['sum_3']],
                'out_num_accumulates': [accs['num_accumulates']],
                'out_old_num_accumulates': [accs['old_num_accumulates']],
                'out_num_updates': [accs['num_updates']],
            },
            attrs={
                'average_window': self.average_window,
                'min_average_window': self.min_average_window,
                'max_average_window': self.max_average_window,
            })

    def _ref(self, program, var):
        """Mirror a var of the training program into `program`."""
        return program.global_block().create_var(
            name=var.name, shape=var.shape, dtype=var.dtype,
            persistable=True)

    def _add_average_apply_op(self, param):
        block = framework.default_main_program().global_block()
        p = self._ref(block.program, param)
        backup = block.create_var(
            name=param.name + '@MA_BACKUP', shape=param.shape,
            dtype=param.dtype, persistable=True)
        sum_1 = self._ref(block.program,
                          self._get_accumulator('sum_1', param))
        sum_2 = self._ref(block.program,
                          self._get_accumulator('sum_2', param))
        sum_3 = self._ref(block.program,
                          self._get_accumulator('sum_3', param))
        num_acc = self._ref(
            block.program, self._get_accumulator('num_accumulates', param))
        old_num_acc = self._ref(
            block.program,
            self._get_accumulator('old_num_accumulates', param))
        from . import layers
        layers.assign(input=p, output=backup)
        total = layers.sums([sum_1, sum_2, sum_3])
        count = layers.cast(
            layers.sums([num_acc, old_num_acc]), dtype=param.dtype)
        avg = layers.elementwise_div(
            x=total, y=layers.clip(count, min=1.0, max=1e30))
        layers.assign(input=avg, output=p)

    def _add_average_restore_op(self, param):
        block = framework.default_main_program().global_block()
        p = self._ref(block.program, param)
        backup = block.create_var(
            name=param.name + '@MA_BACKUP', shape=param.shape,
            dtype=param.dtype, persistable=True)
        from . import layers
        layers.assign(input=backup, output=p)

    @contextmanager
    def apply(self, executor, need_restore=True):
        executor.run(self.apply_program)
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor):
        executor.run(self.restore_program)

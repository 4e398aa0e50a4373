"""Optimizers (counterpart of ``paddle_tpu/fluid/optimizer.py``): the
``Optimizer`` base, SGD, Momentum and Adam.

``minimize`` appends the backward pass, gradient clipping, regularization and
one update op per parameter to the main program, with the accumulators and
the learning-rate var named as in the JAX package (``<param>_velocity_0``,
``<param>_moment1_0``, ``beta1_pow_acc_0``, ``learning_rate_0``) and
initialized in the startup program.  The other optimizers of the JAX package
are not ported yet.
"""

from collections import defaultdict

from . import framework
from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import Variable
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ['Optimizer', 'SGD', 'SGDOptimizer', 'Momentum',
           'MomentumOptimizer', 'Adam', 'AdamOptimizer']


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


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer

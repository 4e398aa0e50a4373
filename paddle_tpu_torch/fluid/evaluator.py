"""Graph-state evaluators (counterpart of ``paddle_tpu/fluid/evaluator.py``;
reference: python/paddle/fluid/evaluator.py).

An Evaluator owns persistable int64 state vars that graph ops update each
minibatch (``sums(..., out=state)``) plus an ``eval`` that reads them, the
reference pattern.  ``ChunkEvaluator``'s ``chunk_eval`` op runs on the
host, so its program runs eagerly (never captured) on every call.
"""

import numpy as np
import torch

from . import layers
from .framework import Program, Variable, program_guard
from .layer_helper import LayerHelper
from .initializer import Constant
from .executor import global_scope

__all__ = ['Accuracy', 'ChunkEvaluator', 'Evaluator']


class Evaluator(object):
    def __init__(self, name, **kwargs):
        self.helper = LayerHelper(name, **kwargs)
        self.states = []
        self.metrics = []

    def reset(self, executor, reset_program=None):
        """Zero every state var in the active scope, on its device."""
        scope = global_scope()
        for var in self.states:
            v = scope.find_var(var.name)
            if v is not None and v.value() is not None:
                v.set_value(torch.zeros_like(_tensor(v.value())))

    def eval(self, executor, eval_program=None):
        raise NotImplementedError()

    def _create_state(self, suffix, dtype, shape):
        state = self.helper.create_global_variable(
            name='_'.join([unique_name(self.helper.name), suffix]),
            persistable=True,
            dtype=dtype,
            shape=shape)
        self.helper.set_variable_initializer(state, Constant(0.0))
        self.states.append(state)
        return state


def unique_name(prefix):
    from . import unique_name as un
    return un.generate(prefix)


def _tensor(value):
    return value.tensor() if hasattr(value, 'tensor') else \
        torch.as_tensor(value)


def _state_count(scope, var):
    """A [1] int64 state var's value as a Python float."""
    return float(_tensor(scope.find_var(var.name).value()).reshape(-1)[0])


class Accuracy(Evaluator):
    """Streaming accuracy (reference evaluator.py Accuracy)."""

    def __init__(self, input, label, k=1, **kwargs):
        super(Accuracy, self).__init__('accuracy', **kwargs)
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError('You can only invoke Evaluator in root block')

        self.total = self._create_state(dtype='int64', shape=[1],
                                        suffix='total')
        self.correct = self._create_state(dtype='int64', shape=[1],
                                          suffix='correct')
        total = self.helper.create_variable_for_type_inference(dtype='int64')
        correct = self.helper.create_variable_for_type_inference(
            dtype='int64')
        acc = layers.accuracy(
            input=input, label=label, k=k, correct=correct, total=total)
        layers.sums(input=[self.total, total], out=self.total)
        layers.sums(input=[self.correct, correct], out=self.correct)
        self.metrics.append(acc)

    def eval(self, executor, eval_program=None):
        if eval_program is None:
            eval_program = Program()
        block = eval_program.global_block()
        with program_guard(main_program=eval_program):
            total = layers.cast(_clone_var(block, self.total), 'float32')
            correct = layers.cast(_clone_var(block, self.correct), 'float32')
            out = layers.elementwise_div(x=correct, y=total)
        return np.array(executor.run(eval_program, fetch_list=[out])[0])


class ChunkEvaluator(Evaluator):
    """Streaming chunk F1 (reference evaluator.py ChunkEvaluator):
    accumulates chunk_eval op counts in persistable state and recomputes
    precision/recall/F1 at eval()."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None):
        super(ChunkEvaluator, self).__init__('chunk_eval')
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError('You can only invoke Evaluator in root block')

        self.num_infer_chunks = self._create_state(
            dtype='int64', shape=[1], suffix='num_infer_chunks')
        self.num_label_chunks = self._create_state(
            dtype='int64', shape=[1], suffix='num_label_chunks')
        self.num_correct_chunks = self._create_state(
            dtype='int64', shape=[1], suffix='num_correct_chunks')
        (precision, recall, f1_score, num_infer_chunks, num_label_chunks,
         num_correct_chunks) = layers.chunk_eval(
             input=input,
             label=label,
             chunk_scheme=chunk_scheme,
             num_chunk_types=num_chunk_types,
             excluded_chunk_types=excluded_chunk_types)
        layers.sums(input=[self.num_infer_chunks, num_infer_chunks],
                    out=self.num_infer_chunks)
        layers.sums(input=[self.num_label_chunks, num_label_chunks],
                    out=self.num_label_chunks)
        layers.sums(input=[self.num_correct_chunks, num_correct_chunks],
                    out=self.num_correct_chunks)
        self.metrics.extend([precision, recall, f1_score])

    def eval(self, executor, eval_program=None):
        scope = global_scope()
        num_infer = _state_count(scope, self.num_infer_chunks)
        num_label = _state_count(scope, self.num_label_chunks)
        num_correct = _state_count(scope, self.num_correct_chunks)
        precision = num_correct / num_infer if num_infer else 0.0
        recall = num_correct / num_label if num_label else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if num_correct else 0.0)
        return np.array([precision, recall, f1], dtype='float32')


def _clone_var(block, var):
    return block.create_var(
        name=var.name,
        shape=var.shape,
        dtype=var.dtype,
        persistable=True)

"""Metric layers (counterpart of ``paddle_tpu/fluid/layers/metric_op.py``:
``accuracy``)."""

from ..layer_helper import LayerHelper

__all__ = ['accuracy']


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of ``input`` (probabilities [N, C]) against ``label``
    [N, 1]: a ``top_k`` op then an ``accuracy`` op."""
    helper = LayerHelper('accuracy', **locals())
    topk_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    topk_indices = helper.create_variable_for_type_inference(dtype='int64')
    helper.append_op(
        type='top_k',
        inputs={'X': [input]},
        outputs={'Out': [topk_out],
                 'Indices': [topk_indices]},
        attrs={'k': k})
    acc_out = helper.create_variable_for_type_inference(dtype='float32')
    if correct is None:
        correct = helper.create_variable_for_type_inference(dtype='int64')
    if total is None:
        total = helper.create_variable_for_type_inference(dtype='int64')
    helper.append_op(
        type='accuracy',
        inputs={
            'Out': [topk_out],
            'Indices': [topk_indices],
            'Label': [label]
        },
        outputs={
            'Accuracy': [acc_out],
            'Correct': [correct],
            'Total': [total]
        })
    acc_out.stop_gradient = True
    return acc_out

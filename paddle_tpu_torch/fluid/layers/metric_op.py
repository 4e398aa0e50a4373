"""Metric layers (counterpart of ``paddle_tpu/fluid/layers/metric_op.py``:
``accuracy`` and ``chunk_eval``, whose op runs on the host)."""

from ..layer_helper import LayerHelper

__all__ = ['accuracy', 'chunk_eval']


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


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    """Chunk detection precision, recall and F1 over tagged sequences
    (reference layers/nn.py chunk_eval; operators/chunk_eval_op.cc).
    Returns (precision, recall, f1, num_infer, num_label, num_correct)."""
    helper = LayerHelper('chunk_eval', **locals())
    precision = helper.create_variable_for_type_inference('float32')
    recall = helper.create_variable_for_type_inference('float32')
    f1_score = helper.create_variable_for_type_inference('float32')
    num_infer_chunks = helper.create_variable_for_type_inference('int64')
    num_label_chunks = helper.create_variable_for_type_inference('int64')
    num_correct_chunks = helper.create_variable_for_type_inference('int64')
    helper.append_op(
        type='chunk_eval',
        inputs={'Inference': [input],
                'Label': [label]},
        outputs={
            'Precision': [precision],
            'Recall': [recall],
            'F1-Score': [f1_score],
            'NumInferChunks': [num_infer_chunks],
            'NumLabelChunks': [num_label_chunks],
            'NumCorrectChunks': [num_correct_chunks],
        },
        attrs={
            'chunk_scheme': chunk_scheme,
            'num_chunk_types': num_chunk_types,
            'excluded_chunk_types': excluded_chunk_types or [],
        })
    return (precision, recall, f1_score, num_infer_chunks,
            num_label_chunks, num_correct_chunks)

"""Metric layers (counterpart of ``paddle_tpu/fluid/layers/metric_op.py``:
``accuracy``, ``auc``, ``precision_recall``, ``positive_negative_pair``
and ``chunk_eval``, whose op runs on the host)."""

from ..layer_helper import LayerHelper

__all__ = ['accuracy', 'auc', 'chunk_eval', 'precision_recall',
           'positive_negative_pair']


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


def auc(input, label, curve='ROC', num_thresholds=200, topk=1):
    """The batch's AUC.  Its var is declared float64, as the JAX package
    declares it; the op computes it in f32, as the JAX package's lowering
    does with 64-bit types off."""
    helper = LayerHelper('auc', **locals())
    auc_out = helper.create_variable_for_type_inference(dtype='float64')
    helper.append_op(
        type='auc',
        inputs={'Predict': [input],
                'Label': [label]},
        outputs={'AUC': [auc_out]},
        attrs={'curve': curve,
               'num_thresholds': num_thresholds})
    auc_out.stop_gradient = True
    return auc_out


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


def precision_recall(input, label, class_number=None):
    """The batch's precision, recall and F1 over the classes ([3]) of the
    probabilities ``input``: a ``top_k`` op takes their argmax."""
    helper = LayerHelper('precision_recall', **locals())
    cls = class_number
    if cls is None:
        shape = getattr(input, 'shape', None)
        if not shape or len(shape) < 2 or shape[-1] is None or \
                int(shape[-1]) < 0:
            raise ValueError(
                'precision_recall: cannot infer class_number from input '
                'shape %r - pass class_number explicitly' % (shape, ))
        cls = int(shape[-1])
    from .nn import topk
    _, idx = topk(input, 1)
    batch_metrics = helper.create_variable_for_type_inference('float32')
    batch_metrics.shape = (3, )
    helper.append_op(
        type='precision_recall',
        inputs={'Indices': [idx],
                'Labels': [label]},
        outputs={'BatchMetrics': [batch_metrics]},
        attrs={'class_number': int(cls)})
    return batch_metrics


def positive_negative_pair(score, label, query_id):
    """(positive, negative, neutral) pair counts over the pairs in one
    query."""
    helper = LayerHelper('positive_negative_pair', **locals())
    pos = helper.create_variable_for_type_inference('float32')
    neg = helper.create_variable_for_type_inference('float32')
    neu = helper.create_variable_for_type_inference('float32')
    helper.append_op(
        type='positive_negative_pair',
        inputs={'Score': [score],
                'Label': [label],
                'QueryID': [query_id]},
        outputs={'PositivePair': [pos],
                 'NegativePair': [neg],
                 'NeutralPair': [neu]})
    return pos, neg, neu

"""Deployment predictor API (counterpart of ``paddle_tpu/inference.py``;
reference: paddle/fluid/inference/api/paddle_inference_api.h:67-177,
PaddleTensor / PaddlePredictor / CreatePaddlePredictor).

A predictor owns a loaded inference program and a scope; ``run`` takes
named inputs (a list of ``PaddleTensor``, LoD ones included, or a dict)
and returns ``PaddleTensor`` outputs; ``clone`` shares the weights with
an executor of its own (the reference's Clone shares the scope,
api_impl.cc:89).  ``NativeConfig(use_gpu=True)``, the default, runs on
``CUDAPlace(device)``, where each block is captured as a CUDA graph at its
second run; ``use_gpu=False`` runs on the CPU.  The JAX package's
``use_tpu`` is accepted as the same switch.
"""

import numpy as np

from . import fluid
from .fluid import core

__all__ = ['PaddleTensor', 'NativeConfig', 'PaddlePredictor',
           'create_paddle_predictor']


class PaddleTensor(object):
    """(reference paddle_inference_api.h:67)"""

    def __init__(self, name=None, data=None, lod=None):
        self.name = name
        self.data = np.asarray(data) if data is not None else None
        self.lod = lod or []

    @property
    def shape(self):
        return list(self.data.shape) if self.data is not None else []


class NativeConfig(object):
    """(reference paddle_inference_api.h NativeConfig)

    half_precision: 'bfloat16' or 'float16' runs the loaded program
    through InferenceTranspiler (batch-norm fold) and Float16Transpiler,
    so the graph computes in half precision while feeds and fetches stay
    f32."""

    def __init__(self,
                 model_dir=None,
                 prog_file=None,
                 param_file=None,
                 use_gpu=True,
                 device=0,
                 half_precision=None,
                 use_tpu=None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.param_file = param_file
        self.use_gpu = bool(use_gpu if use_tpu is None else use_tpu)
        self.device = device
        self.half_precision = half_precision


class PaddlePredictor(object):
    """(reference paddle_inference_api.h:90 / NativePaddlePredictor)"""

    def __init__(self, config, _shared_scope=None, _shared_model=None):
        self._config = config
        place = core.CUDAPlace(config.device) if config.use_gpu \
            else core.CPUPlace()
        self._exe = fluid.Executor(place)
        self._scope = _shared_scope or core.Scope()
        with fluid.scope_guard(self._scope):
            if _shared_model is not None:
                # clone: share the (possibly transpiled) program; the
                # batch-norm fold rewrites the scope and is not idempotent,
                # so a clone never reloads and re-transpiles
                (self._program, self._feed_names,
                 self._fetch_targets) = _shared_model
                return
            (self._program, self._feed_names,
             self._fetch_targets) = fluid.io.load_inference_model(
                 config.model_dir,
                 self._exe,
                 model_filename=config.prog_file,
                 params_filename=config.param_file)
            if getattr(config, 'half_precision', None):
                fluid.InferenceTranspiler().transpile(
                    self._program, scope=self._scope)
                fluid.Float16Transpiler().transpile(
                    self._program, scope=self._scope,
                    dtype=config.half_precision,
                    feeded_var_names=self._feed_names,
                    fetch_var_names=self._fetch_targets)

    @property
    def feed_names(self):
        return list(self._feed_names)

    @property
    def fetch_names(self):
        return [v.name for v in self._fetch_targets]

    def run(self, inputs, batch_size=-1):
        """inputs: list of PaddleTensor (positional per feed_names) or a
        {name: array} dict.  Returns a list of PaddleTensor."""
        if isinstance(inputs, dict):
            feed = dict(inputs)
        else:
            feed = {}
            for i, t in enumerate(inputs):
                name = t.name or self._feed_names[i]
                value = t.data
                if t.lod:
                    lt = core.LoDTensor(np.asarray(value))
                    lt.set_lod(t.lod)
                    value = lt
                feed[name] = value
        with fluid.scope_guard(self._scope):
            outs = self._exe.run(
                self._program, feed=feed, fetch_list=self._fetch_targets)
        return [
            PaddleTensor(name=v.name, data=o)
            for v, o in zip(self._fetch_targets, outs)
        ]

    def clone(self):
        """New predictor sharing weights (reference Run/Clone contract)."""
        return PaddlePredictor(
            self._config, _shared_scope=self._scope,
            _shared_model=(self._program, self._feed_names,
                           self._fetch_targets))


def create_paddle_predictor(config):
    """(reference CreatePaddlePredictor<ConfigT>, :177)"""
    return PaddlePredictor(config)

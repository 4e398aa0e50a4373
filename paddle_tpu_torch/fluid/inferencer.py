"""High-level Inferencer (counterpart of ``paddle_tpu/fluid/inferencer.py``;
reference: python/paddle/fluid/inferencer.py:31).

``infer()`` routes through the serving engine's synchronous (inline)
mode: the same micro-batch padding and trim, shape buckets and
run_eval_multi dispatch as the request-facing server, so the two
surfaces cannot drift.  Runs on ``CUDAPlace(0)`` unless given a place.
``parallel=True`` evaluates on a ``ParallelExecutor`` instead: every rank
of the process group (one without one) is given the same inputs and
returns the predictions of all of them.  (The JAX package routes it
through its engine's dp serving, which is not ported: ROADMAP.md, Queue 1
item 8.)
"""

from . import core
from .framework import Program, program_guard
from .executor import Executor, scope_guard
from . import io as fluid_io
from . import unique_name

__all__ = ['Inferencer']


class Inferencer(object):
    def __init__(self, infer_func, param_path, place=None, parallel=False):
        """infer_func rebuilds the inference program; param_path holds the
        persistables saved by ``io.save_persistables`` (the reference's
        Trainer.save_params)."""
        self.param_path = param_path
        self.scope = core.Scope()
        self.parallel = parallel
        self.place = place if place is not None else core.CUDAPlace(0)

        self.startup_program = Program()
        self.inference_program = Program()
        with program_guard(self.inference_program, self.startup_program):
            with unique_name.guard():
                self.predict_var = infer_func()

        self.exe = Executor(self.place)
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
            fluid_io.load_persistables(
                self.exe, param_path,
                main_program=self.inference_program)

        self.inference_program = self.inference_program.clone(for_test=True)

        if parallel:
            from .parallel_executor import ParallelExecutor
            self._pe = ParallelExecutor(
                use_cuda=self.place.device.type == 'cuda',
                main_program=self.inference_program, scope=self.scope)
            return

        # the serving package imports fluid submodules: import it here
        from .. import serving
        self._engine = serving.InferenceEngine(
            self.inference_program,
            fetch_list=[self.predict_var],
            place=self.place,
            scope=self.scope,
            executor=self.exe,
            config=serving.ServingConfig(steps_per_dispatch=1,
                                         pipeline_depth=1))

    def infer(self, inputs, return_numpy=True):
        """Run one inference request through the serving engine.  Feeds
        whose leading (batch) dims disagree raise a clear ValueError."""
        if not isinstance(inputs, dict):
            raise ValueError('inputs should be a dict of {name: data}')
        if self.parallel:
            return self._pe.run([self.predict_var], feed=inputs,
                                return_numpy=return_numpy)
        with scope_guard(self.scope):
            return self._engine.infer(inputs, return_numpy=return_numpy)

"""High-level Trainer and its event loop (counterpart of
``paddle_tpu/fluid/trainer.py``; reference python/paddle/fluid/
trainer.py).

The reference's event-driven surface (``BeginEpochEvent`` ...
``EndStepEvent``, trainer.py:40-83), checkpoints by ``CheckpointConfig``
(trainer.py:100) and resume from the newest one.  Checkpoints go through
``distributed.elastic.AsyncShardedCheckpoint``: a shard file a var, an
atomic manifest commit, bounded retention, the write on a background
thread.  A checkpoint of the earlier layout (``<dir>/<serial>/``, a file a
var) still resumes.  Runs on ``CUDAPlace(0)`` unless given a place;
``parallel=True`` raises (ROADMAP.md, Queue 1 item 7).
"""

import os
import shutil
import sys

from . import core
from .framework import Program, program_guard
from .executor import Executor, scope_guard
from . import io as fluid_io
from .data_feeder import DataFeeder

__all__ = [
    'Trainer', 'BeginEpochEvent', 'EndEpochEvent', 'BeginStepEvent',
    'EndStepEvent', 'CheckpointConfig',
]


class BeginEpochEvent(object):
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent(object):
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent(object):
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent(object):
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig(object):
    """(reference trainer.py:100)"""

    def __init__(self,
                 checkpoint_dir=None,
                 max_num_checkpoints=3,
                 epoch_interval=1,
                 step_interval=10):
        self.checkpoint_dir = checkpoint_dir or os.path.join(
            os.getcwd(), 'checkpoints')
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = max(epoch_interval, 1)
        self.step_interval = max(step_interval, 1)
        self.epoch_id = 0
        self.step_id = 0
        self.load_serial = None


def _serial_dir(checkpoint_dir, serial):
    return os.path.join(checkpoint_dir, str(serial))


def _latest_serial(checkpoint_dir):
    if not os.path.isdir(checkpoint_dir):
        return None
    serials = [int(d) for d in os.listdir(checkpoint_dir) if d.isdigit()]
    return max(serials) if serials else None


class Trainer(object):
    """(reference trainer.py:169)

    train_func must return [loss] (optionally [loss, *metrics])."""

    def __init__(self,
                 train_func,
                 optimizer_func,
                 param_path=None,
                 place=None,
                 parallel=False,
                 checkpoint_config=None):
        if parallel:
            raise NotImplementedError(
                'Trainer(parallel=True) over a ParallelExecutor is not '
                'ported to PyTorch yet (ROADMAP.md, Queue 1 item 7)')
        self.__stop = False
        self.parallel = parallel
        self.place = place if place is not None else core.CUDAPlace(0)
        self.checkpoint_cfg = checkpoint_config
        if self.checkpoint_cfg is not None and not isinstance(
                self.checkpoint_cfg, CheckpointConfig):
            raise TypeError('checkpoint_config must be CheckpointConfig')

        self.scope = core.Scope()
        self.startup_program = Program()
        self.train_program = Program()

        with program_guard(self.train_program, self.startup_program):
            program_func_outs = train_func()
            self.train_func_outputs = program_func_outs if isinstance(
                program_func_outs, list) else [program_func_outs]
            self.test_program = self.train_program.clone(for_test=True)
            optimizer = optimizer_func()
            loss = self.train_func_outputs[0]
            optimizer.minimize(loss)

        self.exe = Executor(self.place)
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)

        if param_path and os.path.isdir(param_path):
            with scope_guard(self.scope):
                fluid_io.load_persistables(
                    self.exe, dirname=param_path,
                    main_program=self.startup_program)

        self._ckpt_store = None
        if self.checkpoint_cfg is not None:
            self._resume()

    def _resume(self):
        """Open the checkpoint store and load the newest manifest's state
        into the scope; or, with no manifest, the newest checkpoint of the
        earlier ``<dir>/<serial>/`` layout.  The loops do not skip the
        epochs and steps already trained: the state resumes, and where
        the data resumes is the caller's reader's business."""
        from ..distributed.elastic import AsyncShardedCheckpoint
        cfg = self.checkpoint_cfg
        self._ckpt_store = AsyncShardedCheckpoint(
            cfg.checkpoint_dir, keep=cfg.max_num_checkpoints)
        manifest = self._ckpt_store.latest()
        if manifest is not None:
            serial, arrays, extras = self._ckpt_store.load(manifest)
            cfg.load_serial = serial
            cfg.epoch_id = int(extras.get('epoch', 0))
            cfg.step_id = int(extras.get('step', 0))
            device = self.place.device
            for name, value in arrays.items():
                self.scope.var(name).set_value(value.to(device))
            return
        serial = _latest_serial(cfg.checkpoint_dir)
        if serial is not None:
            cfg.load_serial = serial
            with scope_guard(self.scope):
                fluid_io.load_persistables(
                    self.exe, _serial_dir(cfg.checkpoint_dir, serial),
                    main_program=self.train_program)

    def stop(self):
        self.__stop = True

    def train(self, num_epochs, event_handler, reader=None, feed_order=None,
              steps_per_dispatch=1, pipeline_depth=2):
        """Run the event loop.  With ``steps_per_dispatch > 1`` the loop
        rides ``fluid.dataflow.FeedPipeline``: K reader batches train as
        one K-step dispatch while the next block is staged.  Step events
        then fire once a dispatch and after it ran (the next may be in
        flight), so a handler cannot steer the step it names:
        ``fetch_metrics`` is ignored (the metrics are the block's last
        step) and ``stop()`` takes effect up to ``pipeline_depth``
        dispatches late.  A handler that must act before each step (a
        learning rate written to the scope) needs the plain loop."""
        if int(steps_per_dispatch) > 1:
            return self._train_pipelined(
                num_epochs, event_handler, reader, feed_order,
                int(steps_per_dispatch), int(pipeline_depth))
        try:
            with scope_guard(self.scope):
                feeder = DataFeeder(
                    feed_list=feed_order, place=self.place,
                    program=self.train_program)
                for epoch_id in range(num_epochs):
                    event_handler(BeginEpochEvent(epoch_id))
                    for step_id, data in enumerate(reader()):
                        if self.__stop:
                            return
                        begin_event = BeginStepEvent(epoch_id, step_id)
                        event_handler(begin_event)
                        fetch_list = self.train_func_outputs \
                            if begin_event.fetch_metrics else []
                        metrics = self.exe.run(
                            self.train_program,
                            feed=feeder.feed(data),
                            fetch_list=fetch_list)
                        if self.checkpoint_cfg is not None:
                            self._save_checkpoint(epoch_id, step_id)
                        event_handler(
                            EndStepEvent(epoch_id, step_id, metrics))
                    event_handler(EndEpochEvent(epoch_id))
        finally:
            # the writer commits before train() returns; on the exception
            # path quietly, so as not to mask the training error
            self._flush_checkpoints(quiet=sys.exc_info()[0] is not None)

    def _train_pipelined(self, num_epochs, event_handler, reader,
                         feed_order, steps, pipeline_depth):
        """The overlapped loop: an epoch's feeder-prepared batches flow
        through a FeedPipeline; each iteration is one K-step dispatch."""
        from .dataflow import FeedPipeline
        try:
            with scope_guard(self.scope):
                feeder = DataFeeder(
                    feed_list=feed_order, place=self.place,
                    program=self.train_program)
                for epoch_id in range(num_epochs):
                    event_handler(BeginEpochEvent(epoch_id))
                    pipe = FeedPipeline(
                        self.exe, fetch_list=self.train_func_outputs,
                        program=self.train_program,
                        source=(feeder.feed(data) for data in reader()),
                        steps=steps, pipeline_depth=pipeline_depth,
                        scope=self.scope)
                    try:
                        for step_id, metrics in enumerate(pipe):
                            if self.__stop:
                                return
                            event_handler(BeginStepEvent(epoch_id,
                                                         step_id))
                            if self.checkpoint_cfg is not None:
                                self._save_checkpoint(epoch_id, step_id)
                            event_handler(
                                EndStepEvent(epoch_id, step_id, metrics))
                    finally:
                        pipe.close()
                    event_handler(EndEpochEvent(epoch_id))
        finally:
            self._flush_checkpoints(quiet=sys.exc_info()[0] is not None)

    def test(self, reader, feed_order):
        with scope_guard(self.scope):
            feeder = DataFeeder(
                feed_list=feed_order, place=self.place,
                program=self.test_program)
            accumulated = [0.0] * len(self.train_func_outputs)
            count = 0
            for data in reader():
                outs = self.exe.run(
                    self.test_program,
                    feed=feeder.feed(data),
                    fetch_list=self.train_func_outputs)
                accumulated = [
                    a + float(o.flatten()[0])
                    for a, o in zip(accumulated, outs)
                ]
                count += 1
            return [a / max(count, 1) for a in accumulated]

    def save_params(self, param_path):
        with scope_guard(self.scope):
            fluid_io.save_persistables(
                self.exe, dirname=param_path,
                main_program=self.train_program)

    def save_inference_model(self, param_path, feeded_var_names,
                             target_var_indexes):
        with scope_guard(self.scope):
            target_vars = [
                self.train_func_outputs[i] for i in target_var_indexes
            ]
            fluid_io.save_inference_model(param_path, feeded_var_names,
                                          target_vars, self.exe,
                                          self.train_program)

    def _save_checkpoint(self, epoch_id, step_id):
        cfg = self.checkpoint_cfg
        if epoch_id % cfg.epoch_interval != 0 or \
                step_id % cfg.step_interval != 0:
            return
        serial = (cfg.load_serial or 0) + epoch_id * 100000 + step_id + 1
        arrays = {}
        for var in self.train_program.list_vars():
            if not fluid_io.is_persistable(var):
                continue
            sv = self.scope.find_var(var.name)
            if sv is None or sv.value() is None:
                continue
            arrays[var.name] = fluid_io._scope_value(self.scope, var.name)
        # the store copies to the host here; the write is its thread's
        self._ckpt_store.save(serial, arrays,
                              extras={'epoch': epoch_id, 'step': step_id})

    def _flush_checkpoints(self, quiet=False):
        """Wait for the writer, so that the checkpoints are on disk when
        train() returns.  ``quiet`` (the exception path) lets no writer
        failure mask the training error."""
        if self._ckpt_store is None:
            return
        try:
            self._ckpt_store.wait()
        except Exception:
            if not quiet:
                raise
            return
        # a resume from the earlier layout leaves <dir>/<serial>/ trees
        # the store's retention never touches: once a manifest is
        # committed they are superseded
        cfg = self.checkpoint_cfg
        if self._ckpt_store.latest() is not None:
            for d in os.listdir(cfg.checkpoint_dir):
                if d.isdigit():
                    shutil.rmtree(_serial_dir(cfg.checkpoint_dir, d),
                                  ignore_errors=True)

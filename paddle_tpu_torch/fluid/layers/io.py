"""Input layers and the reader pipeline (counterpart of
``paddle_tpu/fluid/layers/io.py``; reference python/paddle/fluid/layers/
io.py).

``py_reader`` feeds minibatches through the native blocking queue
(``csrc/blocking_queue.cc``) from a background thread; the executor pops
each batch on the host, ahead of the step, for the program's ``read`` op
(``read_file``).  ``double_buffer`` adds a prefetch thread that pads the
LoD slots and, for an executor on the card, copies batch N+1 there from
pinned memory on a stream of its own while step N runs (the reference's
create_double_buffer_reader_op.cc); the consumer's stream waits for the
copy's event when it pops the batch.  For an executor on the CPU the batch
stays on the host.
"""

import contextlib
import io as _io
import pickle
import queue as _queue
import random
import threading
import weakref

import numpy as np
import torch

from .. import core
from .. import unique_name
from ..layer_helper import LayerHelper

__all__ = ['data', 'py_reader', 'read_file', 'batch', 'double_buffer',
           'open_recordio_file', 'open_files', 'shuffle', 'Preprocessor',
           'random_data_generator']

# reader var name -> _PyReaderFeeder.  Weak values: the reader Variable
# holds the strong reference, so a dropped program frees its feeder.
_READER_REGISTRY = weakref.WeakValueDictionary()


def get_reader_feeder(name):
    return _READER_REGISTRY.get(name)


def data(name,
         shape,
         append_batch_size=True,
         dtype='float32',
         lod_level=0,
         type=core.VarDesc.VarType.LOD_TENSOR,
         stop_gradient=True):
    """Declare a feed variable.  With ``append_batch_size`` the leading dim
    becomes -1 (batch)."""
    helper = LayerHelper('data', name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.create_global_variable(
        name=name,
        shape=shape,
        dtype=dtype,
        type=type,
        stop_gradient=stop_gradient,
        lod_level=lod_level,
        is_data=True,
        persistable=False)


class _Staged(object):
    """A batch copied to the card on the prefetch stream: its slots and
    the event recorded after the copies."""

    __slots__ = ('slots', 'event')

    def __init__(self, slots, event):
        self.slots = slots
        self.event = event


def _slot_tensors(slot):
    if isinstance(slot, core.PaddedSequence):
        return [t for t in (slot.data, slot.lengths) if t is not None]
    return [slot] if isinstance(slot, torch.Tensor) else []


class _PyReaderFeeder(object):
    """The producer side of a py_reader: a background thread fills the
    native queue, ``pop`` takes one batch (None at the end of a pass)."""

    def __init__(self, capacity, shapes, dtypes, lod_levels):
        from ...runtime import NativeBlockingQueue
        self.queue = NativeBlockingQueue(capacity)
        self.capacity = capacity
        self._closed = False
        self.shapes = shapes
        self.dtypes = dtypes
        self.lod_levels = lod_levels or [0] * len(shapes)
        self._provider = None
        self._thread = None
        self._exhausted = False
        self._error = None
        self._shuffle_buffer = 0
        # one batch handed back by a consumer that drained up to a
        # shape-bucket boundary: the next pop of the same pass delivers it
        self._pushback = None
        # guards the pass state (generation, exhaustion, error) against a
        # pop racing reset() + start()
        self._gen_lock = threading.RLock()
        self._generation = 0
        self._last_pop_gen = 0
        # double_buffer(): a prefetch thread stages each batch for the
        # consuming executor's place while the current step runs
        self._double_buffer_place = None
        self._double_buffer_requested = False
        self._executor_place = None  # bound by the consuming executor
        self._dev_queue = None
        self._convert_thread = None
        self._stream = None  # the prefetch thread's copy stream (the card)

    def _effective_db_place(self):
        """The prefetch target: double_buffer's explicit place, else the
        place of the executor consuming this reader (bound at its pops),
        else that of the executor that ran last, else the host."""
        if self._double_buffer_place is not None:
            return self._double_buffer_place
        if self._executor_place is not None:
            return self._executor_place
        if _last_executor_place is not None:
            return _last_executor_place
        return core.CPUPlace()

    def decorate_paddle_reader(self, reader, places=None):
        """``reader`` yields batches, each a list of sample tuples; each
        batch is converted with DataFeeder's rules."""
        from ..data_feeder import DataToLoDTensorConverter

        def provider():
            for batch_rows in reader():
                converters = [
                    DataToLoDTensorConverter(None, lod, shape, dtype)
                    for lod, shape, dtype in zip(
                        self.lod_levels, self.shapes, self.dtypes)
                ]
                for row in batch_rows:
                    for conv, slot in zip(converters, row):
                        conv.feed(slot)
                yield tuple(c.done() for c in converters)

        self._provider = provider

    def decorate_tensor_provider(self, provider):
        """``provider`` yields tuples of numpy arrays or LoDTensors."""

        def gen():
            for item in provider():
                yield tuple(item)

        self._provider = gen

    def start(self):
        if self._provider is None:
            raise RuntimeError('decorate a data source before start()')
        with self._gen_lock:
            self.queue.reopen()
            self._exhausted = False
            self._error = None
            # each pass is one generation: pop() and push_back() compare
            # against it, so an aborted pass neither hangs on a dead queue
            # nor leaks into the next
            self._generation += 1
        provider = self._provider
        if self._shuffle_buffer > 1:
            provider = _shuffled_provider(provider, self._shuffle_buffer)
        if self._double_buffer_requested:
            self._start_prefetch(provider)
            return

        def work():
            try:
                for batch in provider():
                    # in-process framing only, never written to disk
                    if not self.queue.push(pickle.dumps(batch, protocol=4)):
                        return
            except BaseException as e:  # the consumer's error, not an EOF
                self._error = e
            finally:
                self.queue.close()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    # ---- double_buffer's prefetch.  Batches go producer -> converter as
    # Python references, not serialized bytes: at large batches the pickle
    # round trip costs more than the step. ----
    def _convert_batch(self, item):
        """One batch as the consuming executor takes it: each LoD slot
        padded (a ``PaddedSequence`` with its lengths), and for a place on
        the card every slot copied there from pinned memory on the
        prefetch stream, behind an event (``_Staged``)."""
        from ..executor import _lod_to_padded, CAPTURE_LOCK
        place = self._effective_db_place()
        out = []
        for slot in item:
            if isinstance(slot, core.LoDTensor) and slot.lod():
                if len(slot.lod()) >= 2:
                    raise NotImplementedError(
                        'double_buffer: a nested (%d-level) LoD slot needs '
                        'the @ROWS side-band, which comes with a later '
                        'sequence slice of the PyTorch port'
                        % len(slot.lod()))
                padded, lengths = _lod_to_padded(slot)
                out.append(core.PaddedSequence(torch.from_numpy(padded),
                                               torch.from_numpy(lengths)))
            elif isinstance(slot, core.LoDTensor):
                out.append(slot.tensor())
            else:
                out.append(torch.as_tensor(np.asarray(slot)))
        if place.device.type != 'cuda':
            return tuple(out)
        device = place.device

        def put(t):
            return t.pin_memory().to(device, non_blocking=True)

        with CAPTURE_LOCK:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            with torch.cuda.stream(self._stream):
                staged = tuple(
                    core.PaddedSequence(put(s.data), put(s.lengths))
                    if isinstance(s, core.PaddedSequence) else put(s)
                    for s in out)
                event = torch.cuda.Event()
                event.record(self._stream)
        return _Staged(staged, event)

    def _start_prefetch(self, provider):
        end = object()
        # the threads keep this pass's queues in their closures: a thread
        # of an earlier pass that outlives reset() never touches the next
        # pass's state
        ref_q = _queue.Queue(maxsize=max(2, min(int(self.capacity), 8)))
        dev_q = _queue.Queue(maxsize=2)
        with self._gen_lock:
            # the pass state flips at once for a pop's snapshot
            self._closed = False
            gen = self._generation
            self._dev_queue = dev_q

        def live():
            return not self._closed and self._generation == gen

        def put(q, item):
            while live():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def record_error(e):
            if live():
                self._error = e

        def produce():
            try:
                for batch in provider():
                    if not put(ref_q, tuple(batch)):
                        return
            except BaseException as e:
                record_error(e)
            finally:
                put(ref_q, end)

        def convert():
            try:
                while live():
                    try:
                        item = ref_q.get(timeout=0.1)
                    except _queue.Empty:
                        continue
                    if item is end:
                        put(dev_q, None)
                        return
                    put(dev_q, self._convert_batch(item))
            except BaseException as e:
                record_error(e)
                put(dev_q, None)

        with self._gen_lock:
            self._thread = threading.Thread(target=produce, daemon=True)
            self._convert_thread = threading.Thread(target=convert,
                                                    daemon=True)
        self._thread.start()
        self._convert_thread.start()

    def _eof_or_raise(self):
        """The end of the stream: a provider error once, then EOF on this
        and every later pop until reset()."""
        self._exhausted = True
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                'py_reader data provider failed: %r' % (err, )) from err
        return None

    def push_back(self, batch):
        """Hand one popped batch back: the next pop of this pass delivers
        it again.  A batch whose pass was reset between the pop and the
        push-back is dropped, never delivered into the next pass."""
        with self._gen_lock:
            if self._generation == self._last_pop_gen:
                self._pushback = batch

    @staticmethod
    def _claim(staged):
        """A prefetched batch for the calling thread's stream: the stream
        waits for its copies, and the allocator keeps its blocks until
        that stream's work on them is done."""
        if not isinstance(staged, _Staged):
            return staged
        from ..executor import CAPTURE_LOCK
        tensors = [t for s in staged.slots for t in _slot_tensors(s)]
        with CAPTURE_LOCK:
            stream = torch.cuda.current_stream(tensors[0].device) \
                if tensors else None
            if stream is not None:
                stream.wait_event(staged.event)
                for t in tensors:
                    t.record_stream(stream)
        return staged.slots

    def pop(self):
        with self._gen_lock:
            # one snapshot of the pass: reset() and start() change the
            # push-back, the queues and the generation under this lock
            if self._pushback is not None:
                batch, self._pushback = self._pushback, None
                return batch
            dev_q = self._dev_queue
            gen = self._last_pop_gen = self._generation
        if dev_q is not None:
            if self._exhausted:  # the sentinel comes once
                return None
            while True:
                try:
                    batch = dev_q.get(timeout=0.1)
                    break
                except _queue.Empty:
                    if self._closed or self._generation != gen:
                        # reset() raced this pop: the pass's threads exit
                        # without the sentinel, so this pass reads as EOF
                        # (or its provider's error); a pass already
                        # restarted reads as plain EOF
                        with self._gen_lock:
                            if self._generation != gen:
                                return None
                            return self._eof_or_raise()
            if batch is None:
                return self._eof_or_raise()
            return self._claim(batch)
        data = self.queue.pop()
        if data is None:
            return self._eof_or_raise()
        return pickle.loads(data)

    def reset(self):
        with self._gen_lock:
            self._pushback = None  # a held batch dies with its pass
            self.queue.close()
            self._closed = True
        if self._convert_thread is not None:
            self._convert_thread.join(timeout=5)
            self._convert_thread = None
            self._dev_queue = None
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._thread = None


def py_reader(capacity,
              shapes,
              dtypes,
              lod_levels=None,
              name=None,
              use_double_buffer=True):
    """A feedable reader: a reader Variable with ``decorate_paddle_reader``,
    ``decorate_tensor_provider``, ``start`` and ``reset``; ``read_file``
    gives its data variables."""
    helper = LayerHelper('py_reader', name=name)
    reader = helper.create_global_variable(
        name=unique_name.generate('create_py_reader'),
        type=core.VarDesc.VarType.READER,
        persistable=True)
    feeder = _PyReaderFeeder(capacity, list(shapes), list(dtypes),
                             lod_levels)
    reader._feeder = feeder  # the feeder lives as long as the var
    _READER_REGISTRY[reader.name] = feeder
    reader._shapes = list(shapes)
    reader._dtypes = list(dtypes)
    reader._lod_levels = lod_levels or [0] * len(shapes)
    reader.decorate_paddle_reader = feeder.decorate_paddle_reader
    reader.decorate_tensor_provider = feeder.decorate_tensor_provider
    reader.start = feeder.start
    reader.reset = feeder.reset
    return reader


def read_file(reader):
    """Emit the ``read`` op giving this reader's data variables."""
    helper = LayerHelper('read_file')
    out = []
    for shape, dtype, lod in zip(reader._shapes, reader._dtypes,
                                 reader._lod_levels):
        v = helper.create_variable_for_type_inference(
            dtype, stop_gradient=True)
        v.shape = tuple(shape)
        v.lod_level = lod
        v.is_data = True
        out.append(v)
    helper.append_op(
        type='read',
        inputs={'Reader': [reader]},
        outputs={'Out': out})
    if len(out) == 1:
        return out[0]
    return out


def batch(reader, batch_size):
    """Kept for the reader pipeline's API: batches form on the host."""
    return reader


_last_executor_place = None


def note_executor_place(place):
    """Called at every executor resolve: remembers the place that ran
    last, so that ``double_buffer(place=None)`` stages for the device
    actually running the program (a CPU executor's batches stay on the
    host)."""
    global _last_executor_place
    _last_executor_place = place


def double_buffer(reader, place=None, name=None):
    """Stage batches one step ahead (reference layers/io.py:891,
    create_double_buffer_reader_op.cc): a prefetch thread pads the LoD
    slots and, for a place on the card, copies every slot there, so that
    the copy of batch N+1 overlaps step N.  Takes effect at the reader's
    next ``start()``.  With ``place=None`` the target is the place of the
    executor consuming the reader, bound at its pops."""
    feeder = get_reader_feeder(reader.name)
    if feeder is not None:
        feeder._double_buffer_place = place
        feeder._double_buffer_requested = True
    return reader


def _shuffled_provider(provider, buffer_size):

    def gen():
        buf = []
        for item in provider():
            buf.append(item)
            if len(buf) >= buffer_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        random.shuffle(buf)
        for b in buf:
            yield b

    return gen


def shuffle(reader, buffer_size):
    """Shuffle a py_reader's batches through a host-side buffer of
    ``buffer_size`` batches."""
    feeder = get_reader_feeder(reader.name)
    if feeder is not None:
        feeder._shuffle_buffer = int(buffer_size)
    return reader


def _decode_npz_record(rec):
    """A recordio record: an npz-framed tuple of arrays (data only, no
    pickled objects), as ``recordio_writer`` writes it in either
    package."""
    with np.load(_io.BytesIO(rec), allow_pickle=False) as z:
        return tuple(z['arr_%d' % i] for i in range(len(z.files)))


def _scan_file(filename):
    from ...runtime import RecordIOScanner
    scanner = RecordIOScanner(filename)
    try:
        for rec in scanner:
            yield _decode_npz_record(rec)
    finally:
        scanner.close()


def open_recordio_file(filename,
                       shapes,
                       dtypes,
                       lod_levels=None,
                       pass_num=1,
                       for_parallel=True):
    """A reader over a recordio file that ``recordio_writer`` wrote
    (reference operators/reader/create_recordio_file_reader_op.cc)."""
    rd = py_reader(64, shapes, dtypes, lod_levels)

    def provider():
        for _ in range(pass_num):
            for item in _scan_file(filename):
                yield item

    rd.decorate_tensor_provider(provider)
    return rd


def open_files(filenames,
               shapes,
               lod_levels,
               dtypes,
               thread_num=None,
               buffer_size=None,
               pass_num=1,
               is_test=None):
    """A reader over several recordio files, read by ``thread_num`` threads
    (reference layers/io.py:724, operators/reader/open_files_op.cc).
    ``is_test`` (or one thread) keeps the files' order; otherwise the
    threads interleave them."""
    thread_num = (1 if is_test else
                  min(thread_num or len(filenames), len(filenames)))
    buffer_size = buffer_size or 3 * thread_num
    rd = py_reader(buffer_size, shapes, dtypes, lod_levels)

    def provider():
        for _ in range(pass_num):
            if thread_num == 1:
                for fname in filenames:
                    for item in _scan_file(fname):
                        yield item
                continue
            q = _queue.Queue(maxsize=buffer_size)
            done = object()
            errors = []

            def work(my_files):
                try:
                    for fname in my_files:
                        for item in _scan_file(fname):
                            q.put(item)
                except BaseException as e:
                    # a reader thread's failure reaches the consumer: a
                    # truncated pass must not look like a clean EOF
                    errors.append(e)
                finally:
                    q.put(done)

            shards = [filenames[i::thread_num] for i in range(thread_num)]
            workers = [threading.Thread(target=work, args=(shard, ),
                                        daemon=True) for shard in shards]
            for w in workers:
                w.start()
            finished = 0
            while finished < thread_num:
                item = q.get()
                if item is done:
                    finished += 1
                else:
                    yield item
            for w in workers:
                w.join()
            if errors:
                raise RuntimeError(
                    'open_files reader thread failed: %r' %
                    (errors[0], )) from errors[0]

    rd.decorate_tensor_provider(provider)
    return rd


def random_data_generator(low, high, shapes, lod_levels, for_parallel=True):
    """A reader of uniform random float32 batches in [low, high)
    (reference layers/io.py:410, create_random_data_generator_op.cc): it
    makes its batches itself and is started already."""
    shapes = [list(s) for s in shapes]
    reader = py_reader(
        capacity=4,
        shapes=shapes,
        dtypes=['float32'] * len(shapes),
        lod_levels=list(lod_levels))
    rng = np.random.RandomState(0)

    def provider():
        while True:
            yield tuple(rng.uniform(low, high, size=s).astype('float32')
                        for s in shapes)

    feeder = get_reader_feeder(reader.name)
    feeder.decorate_tensor_provider(provider)
    feeder.start()
    return reader


class Preprocessor(object):
    """A reader transform (reference layers/io.py Preprocessor,
    create_custom_reader_op.cc): the ops defined between ``inputs()`` and
    ``outputs()`` in ``block()`` run on every batch the underlying reader
    yields, through the port's lowerings (a program of those ops run by
    an executor on the CPU, as each batch is popped)."""

    BEFORE_SUB_BLOCK = 0
    IN_SUB_BLOCK = 1
    AFTER_SUB_BLOCK = 2

    def __init__(self, reader, name=None):
        self.underlying = reader
        self.helper = LayerHelper('create_custom_reader', name=name)
        self.status = Preprocessor.BEFORE_SUB_BLOCK
        self.main_prog = self.helper.main_program
        self.sub_block = None
        self.source_vars = None
        self.sink_vars = None

    def _is_completed(self):
        return self.sub_block and self.source_vars and self.sink_vars

    @contextlib.contextmanager
    def block(self):
        self.status = Preprocessor.IN_SUB_BLOCK
        self.sub_block = self.main_prog.create_block()
        try:
            yield
        finally:
            self.main_prog.rollback()
            self.status = Preprocessor.AFTER_SUB_BLOCK
            if not self._is_completed():
                raise RuntimeError(
                    'Preprocessor block needs inputs() and outputs()')
            self._install()

    def inputs(self):
        if self.status != Preprocessor.IN_SUB_BLOCK:
            raise RuntimeError(
                'Preprocessor.inputs() must be called inside block()')
        feeder = get_reader_feeder(self.underlying.name)
        self.source_vars = []
        for i, (shape, dtype) in enumerate(
                zip(feeder.shapes, feeder.dtypes)):
            v = self.sub_block.create_var(
                name=unique_name.generate('preprocessor_src_%d' % i),
                dtype=dtype)
            v.shape = tuple(shape)
            self.source_vars.append(v)
        return self.source_vars

    def outputs(self, *outs):
        if self.status != Preprocessor.IN_SUB_BLOCK:
            raise RuntimeError(
                'Preprocessor.outputs() must be called inside block()')
        self.sink_vars = list(outs)

    def _install(self):
        from ..executor import Executor
        from ..framework import Program
        src_names = [v.name for v in self.source_vars]
        sink_names = [v.name for v in self.sink_vars]
        prog = Program()
        blk = prog.global_block()
        for v in self.source_vars:
            nv = blk.create_var(name=v.name, dtype=v.dtype)
            nv.shape = getattr(v, 'shape', None)
            nv.is_data = True
        for op in self.sub_block.ops:
            blk.append_op(type=op.type, inputs=dict(op.inputs),
                          outputs=dict(op.outputs), attrs=dict(op.attrs))
        for name, v in self.sub_block.vars.items():
            if name not in blk.vars:
                blk.vars[name] = v
        underlying_feeder = get_reader_feeder(self.underlying.name)
        exe = Executor(core.CPUPlace())
        original_pop = underlying_feeder.pop

        def transforming_pop():
            batch = original_pop()
            if batch is None:
                return None
            outs = exe.run(prog, feed=dict(zip(src_names, batch)),
                           fetch_list=sink_names)
            return tuple(np.asarray(o) for o in outs)

        underlying_feeder.pop = transforming_pop

    def __call__(self):
        return self.underlying

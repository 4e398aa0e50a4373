"""DataFeeder: convert python/numpy minibatch rows into feed tensors
(counterpart of ``paddle_tpu/fluid/data_feeder.py``; reference:
python/paddle/fluid/data_feeder.py:83).

``feed`` gives one ``core.LoDTensor`` a feed var, with a one-level LoD for
a sequence var, which ``Executor.run`` pads to [B, T, ...] with its
``@SEQLEN`` lengths.  ``feed_parallel`` and
``decorate_reader(multi_devices=True)`` deal a batch's samples to several
places, as the reference does.
"""

import numpy as np

from . import core
from .framework import Variable, default_main_program

__all__ = ['DataFeeder']


class DataToLoDTensorConverter(object):
    """Accumulates per-example data, emits one (possibly LoD) tensor
    (reference data_feeder.py:29)."""

    def __init__(self, place, lod_level, shape, dtype):
        self.place = place
        self.lod_level = lod_level
        self.shape = shape
        self.dtype = core.convert_dtype_to_np(dtype)
        self._reset()

    def _reset(self):
        self.data = []
        self.lod = [[] for _ in range(self.lod_level)]

    def feed(self, data):
        self._feed_impl_(data, self.lod, self.lod_level)

    def _feed_impl_(self, data, lod, lod_level):
        if lod_level == 0:
            self.data.append(data)
        else:
            lod[0].append(len(data))
            for each_data in data:
                self._feed_impl_(each_data, lod[1:], lod_level - 1)

    def done(self):
        if self.lod_level == 0:
            arr = np.array(self.data, dtype=self.dtype)
            if self.shape:
                try:
                    arr = arr.reshape((-1, ) + tuple(
                        s for s in self.shape[1:] if s > 0)) \
                        if -1 in self.shape or arr.size else arr
                except ValueError:
                    pass
            t = core.LoDTensor(arr)
        else:
            flat = []

            def _flatten(d, level):
                if level == 0:
                    flat.append(d)
                else:
                    for x in d:
                        _flatten(x, level - 1)

            for row in self.data:
                _flatten(row, 0)
            arr = np.concatenate(
                [np.asarray(d, dtype=self.dtype).reshape(
                    (-1, ) + tuple(s for s in self.shape[1:] if s > 0))
                 for d in self.data]) if self.data else np.empty(
                     (0, ), dtype=self.dtype)
            t = core.LoDTensor(arr)
            t.set_recursive_sequence_lengths(self.lod)
        self._reset()
        return t


class DataFeeder(object):
    def __init__(self, feed_list, place, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        if program is None:
            program = default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError('Feed list should contain Variables')
            self.feed_dtypes.append(each_var.dtype)
            self.feed_names.append(each_var.name)
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_shapes.append(each_var.shape)
        self.place = place

    def feed(self, iterable):
        converters = [
            DataToLoDTensorConverter(
                place=self.place,
                lod_level=lod_level,
                shape=shape,
                dtype=dtype)
            for lod_level, shape, dtype in zip(
                self.feed_lod_level, self.feed_shapes, self.feed_dtypes)
        ]
        for each_sample in iterable:
            assert len(each_sample) == len(converters), (
                'The number of fields in data (%s) does not match len(feed_list)'
                ' (%s)' % (len(each_sample), len(converters)))
            for each_converter, each_slot in zip(converters, each_sample):
                each_converter.feed(each_slot)
        ret_dict = {}
        for each_name, each_converter in zip(self.feed_names, converters):
            ret_dict[each_name] = each_converter.done()
        return ret_dict

    def decorate_reader(self, reader, multi_devices=False, num_places=None,
                        drop_last=True):
        """Wrap a batched sample reader into one yielding ready feed
        dicts (reference data_feeder.py decorate_reader); with
        ``multi_devices`` each batch is dealt to ``num_places`` places
        (``feed_parallel``), its remainder dropped under ``drop_last``."""

        def decorated():
            n_places = num_places or 1
            for batch in reader():
                if multi_devices:
                    batch = list(batch)
                    rem = len(batch) % n_places
                    if rem and drop_last:
                        # uneven shards would give the places mismatched
                        # shapes: drop the remainder
                        batch = batch[:len(batch) - rem]
                    if len(batch) < n_places:
                        continue  # cannot cover every place
                    yield self.feed_parallel(batch, n_places)
                else:
                    yield self.feed(batch)

        return decorated

    def feed_parallel(self, iterable, num_places=None):
        """Deal a batch's samples round-robin to ``num_places`` places, one
        feed dict each (reference data_feeder.py:201).  A
        ``ParallelExecutor`` takes the global batch and splits it itself."""
        if num_places is None:
            num_places = 1
        batches = [[] for _ in range(num_places)]
        for i, sample in enumerate(iterable):
            batches[i % num_places].append(sample)
        return [self.feed(b) for b in batches if b]

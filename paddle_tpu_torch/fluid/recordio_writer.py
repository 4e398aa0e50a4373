"""Write a batched reader into recordio files (counterpart of
``paddle_tpu/fluid/recordio_writer.py``; reference python/paddle/fluid/
recordio_writer.py).

Each batch is one record: its feed arrays in ``feed_order``, npz-framed
(data only) as the JAX package frames them, inside the chunked recordio
container of ``csrc/recordio.cc``; so a file written by either package
reads in the other.
"""

import io as _io

import numpy as np

from ..runtime import RecordIOWriter
from . import core

__all__ = ['convert_reader_to_recordio_file',
           'convert_reader_to_recordio_files']


def _serialize_batch(arrays):
    buf = _io.BytesIO()
    np.savez(buf, *[a.numpy() if isinstance(a, core.LoDTensor)
                    else np.asarray(a) for a in arrays])
    return buf.getvalue()


def convert_reader_to_recordio_file(filename,
                                    reader_creator,
                                    feeder,
                                    compressor='zlib',
                                    max_num_records=1000,
                                    feed_order=None):
    """Drain a batched reader through a DataFeeder into one recordio file;
    returns the record count (reference recordio_writer.py:36)."""
    if feed_order is None:
        feed_order = feeder.feed_names
    counter = 0
    with RecordIOWriter(filename, compressor=compressor) as w:
        for batch in reader_creator():
            feed_dict = feeder.feed(batch)
            w.write(_serialize_batch([feed_dict[n] for n in feed_order]))
            counter += 1
            if counter >= max_num_records:
                break
    return counter


def convert_reader_to_recordio_files(filename,
                                     batch_per_file,
                                     reader_creator,
                                     feeder,
                                     compressor='zlib',
                                     max_num_records=1000,
                                     feed_order=None):
    """The same into files of ``batch_per_file`` records each, named
    ``<stem>-NNNNN.<ext>``; returns their names."""
    if feed_order is None:
        feed_order = feeder.feed_names
    f_name, f_ext = filename.rsplit('.', 1)
    files = []
    batch_id = 0
    w = None
    try:
        for batch in reader_creator():
            if batch_id % batch_per_file == 0:
                if w is not None:
                    w.close()
                name = '%s-%05d.%s' % (f_name, batch_id // batch_per_file,
                                       f_ext)
                files.append(name)
                w = RecordIOWriter(name, compressor=compressor)
            feed_dict = feeder.feed(batch)
            w.write(_serialize_batch([feed_dict[n] for n in feed_order]))
            batch_id += 1
            if batch_id >= max_num_records:
                break
    finally:
        if w is not None:
            w.close()
    return files

"""The PyTorch port's data layer held against the JAX package on the CPU:
the native runtime (the recordio container and the blocking queue, built
from ``csrc/`` into ``build/runtime/``), a py_reader training loop to
``EOFException``, ``recordio_writer`` with ``open_recordio_file`` and
``open_files``, ``double_buffer`` (batches staged for the executor's
place, LoD slots padded), and the reader decorators.  Each case mirrors
one of ``tests/test_data_layer.py`` (all but its ``ParallelExecutor``
case); two more hold recordio files written by one package and read by the
other.

Both packages build the same program with the same names, the port's
scope taking the JAX package's startup state, and get the same seeded
batches.  Losses are held with ``allclose`` at rtol 1e-5, atol 1e-6: the
same f32 arithmetic up to summation order over a few SGD steps of one fc
(a sum-pooled embedding's).  The runtime's cases compare bytes exactly.
"""

import faulthandler
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.reader as jreader
import paddle_tpu_torch
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.reader as treader
from paddle_tpu import runtime as jruntime
from paddle_tpu_torch import runtime as truntime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
TIME_LIMIT_S = 120
PKGS = (('jax', jfluid), ('torch', tfluid))
RUNTIMES = {'jax': jruntime, 'torch': truntime}


@pytest.fixture(autouse=True)
def _names_and_time_limit():
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    try:
        with jfluid.unique_name.guard(), tfluid.unique_name.guard():
            yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def _state(pkg, prog, scope):
    """{name: array} of the program's persistable tensors in ``scope``."""
    out = {}
    for v in prog.list_vars():
        if not v.persistable or \
                v.type == jfluid.core.VarDesc.VarType.READER:
            continue
        var = scope.find_var(v.name)
        if var is None or var.value() is None:
            continue
        val = var.value()
        out[v.name] = (np.array(jfluid.executor.as_numpy(val))
                       if pkg == 'jax' else val.numpy())
    return out


def _run_both(build, scenario):
    """``build(fluid)`` -> (main, startup, ...) in each package; the JAX
    package runs its startup, the port's scope takes that state; then
    ``scenario(fluid, exe, built)`` runs in each package's scope.
    Returns {pkg: result}."""
    out, start = {}, None
    for pkg, fluid in PKGS:
        built = build(fluid)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.core.Scope()
        with fluid.scope_guard(scope):
            if pkg == 'jax':
                exe.run(built[1])
                start = _state('jax', built[0], scope)
            else:
                for name, arr in start.items():
                    scope.var(name).set_value(torch.tensor(arr))
            out[pkg] = scenario(fluid, exe, built)
    return out


def _losses_until_eof(fluid, exe, main, rd, loss):
    losses = []
    while True:
        try:
            lv, = exe.run(main, fetch_list=[loss])
        except fluid.core.EOFException:
            rd.reset()
            return losses
        losses.append(float(np.asarray(lv).reshape(-1)[0]))


# ---- the native runtime --------------------------------------------------

def test_pipeline_modules_import_neither_jax_nor_paddle_tpu():
    """The slice's modules, imported alone, bring in neither JAX nor the
    JAX package."""
    code = ('import sys, paddle_tpu_torch.runtime, '
            'paddle_tpu_torch.distributed, paddle_tpu_torch.fluid.dataflow, '
            'paddle_tpu_torch.fluid.trainer, '
            'paddle_tpu_torch.fluid.recordio_writer, '
            'paddle_tpu_torch.fluid.layers.io; '
            'bad = sorted(m for m in sys.modules if m == "jax" or '
            'm.startswith(("jax.", "paddle_tpu.")) or m == "paddle_tpu"); '
            'print(bad); sys.exit(1 if bad else 0)')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=100)
    assert res.returncode == 0, res.stdout + res.stderr


def test_native_lib_builds_into_build_dir():
    """The port builds its library from csrc/ into build/runtime/ (g++ and
    zlib.h are here), never into the JAX package."""
    assert truntime.lib_available()
    from paddle_tpu_torch.runtime import native
    assert native._SO_PATH.endswith(os.path.join('build', 'runtime',
                                                 'libpaddle_tpu_rt.so'))
    assert os.path.exists(native._SO_PATH)


def test_recordio_roundtrip_like_jax(tmp_path):
    """Records written by the port read back the same through either
    package's scanner."""
    path = str(tmp_path / 'data.recordio')
    records = [b'hello', b'world' * 100, b'', b'\x00\x01\x02']
    with truntime.RecordIOWriter(path, compressor='zlib') as w:
        for r in records:
            w.write(r)
    for pkg, rt in RUNTIMES.items():
        scanner = rt.RecordIOScanner(path)
        assert list(scanner) == records, pkg
        scanner.close()


def test_recordio_python_path_writes_the_same_format(tmp_path, monkeypatch):
    """Without the native library the port's pure-Python path writes the
    same container: the JAX package's scanner reads it."""
    from paddle_tpu_torch.runtime import native
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_lib_tried', True)
    path = str(tmp_path / 'py.recordio')
    records = [b'a' * 1000, b'', b'xyz']
    with truntime.RecordIOWriter(path) as w:
        for r in records:
            w.write(r)
    assert list(jruntime.RecordIOScanner(path)) == records
    assert list(truntime.RecordIOScanner(path)) == records
    q = truntime.NativeBlockingQueue(2)
    assert q.push(b'x') and q.size() == 1
    q.close()
    assert q.pop() == b'x' and q.pop() is None and not q.push(b'y')


def test_recordio_detects_corruption_like_jax(tmp_path):
    """A flipped payload byte fails the chunk's CRC: IOError in both."""
    path = str(tmp_path / 'bad.recordio')
    with truntime.RecordIOWriter(path) as w:
        w.write(b'x' * 1000)
    raw = bytearray(open(path, 'rb').read())
    raw[-3] ^= 0xFF
    open(path, 'wb').write(bytes(raw))
    for pkg, rt in RUNTIMES.items():
        with pytest.raises((IOError, OSError)):
            list(rt.RecordIOScanner(path))


def test_blocking_queue_producer_consumer_like_jax():
    """A producer thread through a 4-slot queue: every item once, in order,
    then None after close, in both packages' queues."""
    items = [b'%d' % i for i in range(100)]
    for pkg, rt in RUNTIMES.items():
        q = rt.NativeBlockingQueue(4)

        def produce():
            for it in items:
                q.push(it)
            q.close()

        t = threading.Thread(target=produce)
        t.start()
        got = []
        while True:
            d = q.pop()
            if d is None:
                break
            got.append(d)
        t.join(timeout=30)
        assert not t.is_alive() and got == items, pkg


# ---- py_reader, recordio readers ----------------------------------------

def _classifier(fluid, rd_fn, width=8, classes=4):
    """main, startup, reader, loss: a softmax fc over ``rd_fn``'s reader,
    SGD at lr 0.1."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        rd = rd_fn(fluid)
        img, label = fluid.layers.read_file(rd)
        pred = fluid.layers.fc(img, classes, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, rd, loss


def _py_reader(fluid, width=8):
    return fluid.layers.py_reader(capacity=8, shapes=[[-1, width], [-1, 1]],
                                  dtypes=['float32', 'int64'])


def test_py_reader_trains_with_eof_like_jax():
    """Two passes of five batches each: run() until EOFException, reset();
    the same losses in both packages."""
    def batches():
        rng = np.random.RandomState(0)
        return [(rng.standard_normal((16, 8)).astype('float32'),
                 rng.randint(0, 4, (16, 1)).astype('int64'))
                for _ in range(5)]

    def scenario(fluid, exe, built):
        main, _, rd, loss = built
        rd.decorate_tensor_provider(lambda: iter(batches()))
        passes = []
        for _ in range(2):
            rd.start()
            passes.append(_losses_until_eof(fluid, exe, main, rd, loss))
        return passes

    got = _run_both(lambda f: _classifier(f, _py_reader), scenario)
    assert [len(p) for p in got['torch']] == [5, 5]
    np.testing.assert_allclose(got['torch'], got['jax'], **TOL)


def _feeder_prog(fluid):
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        fluid.layers.data('x', [4])
        fluid.layers.data('y', [1], dtype='int64')
    return prog


def _write_batches(fluid, path, batches):
    feeder = fluid.DataFeeder(feed_list=['x', 'y'], place=fluid.CPUPlace(),
                              program=_feeder_prog(fluid))
    return fluid.recordio_writer.convert_reader_to_recordio_file(
        path, lambda: iter(batches), feeder)


def _sample_batches(seed, n, rows=8):
    rng = np.random.RandomState(seed)
    return [[(rng.standard_normal(4).astype('float32'), [int(i % 3)])
             for i in range(rows)] for _ in range(n)]


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_recordio_file_written_by_one_package_reads_in_the_other(
        tmp_path, writer):
    """recordio_writer's npz-framed records, written by ``writer``'s
    package, read back through open_recordio_file in both packages: the
    same batches, bitwise."""
    path = str(tmp_path / 'train.recordio')
    batches = _sample_batches(1, 3)
    assert _write_batches(dict(PKGS)[writer], path, batches) == 3
    read = {}
    for pkg, fluid in PKGS:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            rd = fluid.layers.open_recordio_file(
                path, shapes=[[-1, 4], [-1, 1]], dtypes=['float32', 'int64'])
            x, y = fluid.layers.read_file(rd)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.core.Scope()):
            rd.start()
            got = []
            while True:
                try:
                    got.append([np.asarray(a) for a in exe.run(
                        main, fetch_list=[x, y])])
                except fluid.core.EOFException:
                    break
        read[pkg] = got
    assert len(read['torch']) == len(read['jax']) == 3
    for (xt, yt), (xj, yj), batch in zip(read['torch'], read['jax'],
                                         batches):
        want = np.stack([s[0] for s in batch])
        np.testing.assert_array_equal(xt, want)
        np.testing.assert_array_equal(xj, want)
        np.testing.assert_array_equal(yt.reshape(-1), yj.reshape(-1))


def test_recordio_file_reader_pipeline_like_jax(tmp_path):
    """Batches written by the port's recordio_writer train through
    open_recordio_file until EOFException; the same means in both."""
    path = str(tmp_path / 'train.recordio')
    assert _write_batches(tfluid, path, _sample_batches(1, 3)) == 3
    means = {}
    for pkg, fluid in PKGS:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            rd = fluid.layers.open_recordio_file(
                path, shapes=[[-1, 4], [-1, 1]], dtypes=['float32', 'int64'])
            x_var, _ = fluid.layers.read_file(rd)
            s = fluid.layers.mean(x_var)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.core.Scope()):
            rd.start()
            means[pkg] = []
            while True:
                try:
                    means[pkg].append(float(np.asarray(
                        exe.run(main, fetch_list=[s])[0]).reshape(-1)[0]))
                except fluid.core.EOFException:
                    break
    assert len(means['torch']) == 3
    np.testing.assert_allclose(means['torch'], means['jax'], **TOL)


def test_open_files_multi_file_reader_like_jax(tmp_path):
    """open_files streams every record of three recordio files on two
    threads: every row once, in both packages."""
    files, total = [], 0
    rng = np.random.RandomState(0)
    for fi in range(3):
        path = os.path.join(str(tmp_path), 'part-%d.recordio' % fi)
        n = 4 + fi
        total += n
        data = [(rng.standard_normal(4).astype('float32'), [fi])
                for _ in range(n)]
        feeder = tfluid.DataFeeder(feed_list=['x', 'y'],
                                   place=tfluid.CPUPlace(),
                                   program=_feeder_prog(tfluid))
        tfluid.recordio_writer.convert_reader_to_recordio_file(
            path, paddle_tpu_torch.batch(lambda d=data: iter(d), 2), feeder)
        files.append(path)
    seen = {}
    for pkg, fluid in PKGS:
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            reader = fluid.layers.open_files(
                filenames=files, shapes=[[-1, 4], [-1, 1]],
                lod_levels=[0, 0], dtypes=['float32', 'int64'],
                thread_num=2)
            xv, yv = fluid.layers.read_file(reader)
            s = fluid.layers.reduce_sum(xv)
        exe = fluid.Executor(fluid.CPUPlace())
        labels = []
        with fluid.scope_guard(fluid.core.Scope()):
            reader.start()
            while True:
                try:
                    _, yb = exe.run(prog, fetch_list=[s, yv])
                except fluid.core.EOFException:
                    break
                labels.extend(np.asarray(yb).reshape(-1).tolist())
        seen[pkg] = sorted(labels)
    assert len(seen['torch']) == total
    assert seen['torch'] == seen['jax']


def test_reader_decorators_like_jax():
    """firstn, map_readers, buffered, compose and shuffle give what the
    JAX package's give."""
    def r():
        return iter(range(10))

    for mod in (jreader, treader):
        assert list(mod.firstn(r, 3)()) == [0, 1, 2]
        assert list(mod.map_readers(lambda a: a * 2, r)())[:3] == [0, 2, 4]
        assert sorted(mod.buffered(r, 2)()) == list(range(10))
        assert list(mod.compose(r, r)())[0] == (0, 0)
        assert sorted(mod.shuffle(r, 5)()) == list(range(10))


# ---- double_buffer --------------------------------------------------------

def _db_classifier(fluid):
    return _classifier(fluid, lambda f: f.layers.double_buffer(
        f.layers.batch(_py_reader(f), batch_size=16)))


def test_double_buffer_stages_for_the_executor_place_like_jax():
    """double_buffer's prefetch trains batch for batch as the unbuffered
    reader does; in the port a batch popped for a CPU executor stays on
    the host as torch tensors (never staged to a card); the same losses
    as the JAX package's."""
    def batches():
        rng = np.random.RandomState(7)
        return [(rng.standard_normal((16, 8)).astype('float32'),
                 rng.randint(0, 4, (16, 1)).astype('int64'))
                for _ in range(6)]

    def scenario(buffered):
        def run(fluid, exe, built):
            main, _, rd, loss = built
            if not buffered:
                feeder = fluid.layers.io.get_reader_feeder(rd.name)
                feeder._double_buffer_requested = False
            rd.decorate_tensor_provider(lambda: iter(batches()))
            rd.start()
            return _losses_until_eof(fluid, exe, main, rd, loss)
        return run

    buffered = _run_both(_db_classifier, scenario(True))
    plain = _run_both(_db_classifier, scenario(False))
    for pkg in ('jax', 'torch'):
        assert len(buffered[pkg]) == len(plain[pkg]) == 6
        np.testing.assert_allclose(buffered[pkg], plain[pkg], rtol=1e-6)
    np.testing.assert_allclose(buffered['torch'], buffered['jax'], **TOL)

    # what a CPU executor pops: torch tensors on the host
    main, startup, rd, loss = _db_classifier(tfluid)
    feeder = tfluid.layers.io.get_reader_feeder(rd.name)
    tfluid.Executor(tfluid.CPUPlace()).run(startup,
                                           scope=tfluid.core.Scope())
    rd.decorate_tensor_provider(lambda: iter(
        [(np.zeros((4, 8), 'float32'), np.zeros((4, 1), 'int64'))]))
    rd.start()
    batch = feeder.pop()
    assert all(isinstance(s, torch.Tensor) and s.device.type == 'cpu'
               for s in batch), [type(s) for s in batch]
    assert feeder.pop() is None
    rd.reset()


def test_double_buffer_lod_feed_padded_like_jax():
    """A LoD slot is popped as a PaddedSequence (padded with its lengths)
    and trains as the host LoDTensor does: three steps, the same losses as
    the JAX package's."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            rd = fluid.layers.py_reader(
                capacity=4, shapes=[[-1, 1], [-1, 1]],
                dtypes=['int64', 'int64'], lod_levels=[1, 0])
            rd = fluid.layers.double_buffer(rd)
            words, label = fluid.layers.read_file(rd)
            emb = fluid.layers.embedding(input=words, size=[30, 8])
            pooled = fluid.layers.sequence_pool(input=emb, pool_type='sum')
            pred = fluid.layers.fc(pooled, 3, act='softmax')
            loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
            fluid.optimizer.SGD(0.1).minimize(loss)
        return main, startup, rd, loss

    def scenario(fluid, exe, built):
        main, _, rd, loss = built
        rng = np.random.RandomState(3)

        def provider():
            for _ in range(3):
                rows = [rng.randint(0, 30, (l, 1)) for l in (3, 5, 2)]
                yield (fluid.create_lod_tensor(
                    np.concatenate(rows).astype('int64'),
                    [[len(r) for r in rows]], fluid.CPUPlace()),
                       rng.randint(0, 3, (3, 1)).astype('int64'))

        rd.decorate_tensor_provider(provider)
        rd.start()
        if fluid is tfluid:
            feeder = fluid.layers.io.get_reader_feeder(rd.name)
            first = feeder.pop()
            feeder.push_back(first)
            assert isinstance(first[0], fluid.core.PaddedSequence)
        return _losses_until_eof(fluid, exe, main, rd, loss)

    got = _run_both(build, scenario)
    assert len(got['torch']) == 3 and all(np.isfinite(got['torch']))
    np.testing.assert_allclose(got['torch'], got['jax'], **TOL)

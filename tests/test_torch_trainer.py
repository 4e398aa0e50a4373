"""The PyTorch port's ``Trainer`` and its checkpoint store held against the
JAX package on the CPU: the Trainer/Inferencer round trip on uci_housing
(the counterpart of ``tests/test_aux.py::test_trainer_inferencer_roundtrip``),
checkpoints written by one package's Trainer and resumed by the other's
(the shard files keep the JAX package's LoDTensor format and manifest), a
pipelined run stopped after an epoch and resumed against an uninterrupted
one, the earlier ``<dir>/<serial>/`` layout, and
``distributed.elastic.AsyncShardedCheckpoint`` (retention, the manifest,
the shard bytes, a failing writer).

Both packages build the same programs with the same names; a port Trainer
takes the JAX package's startup state where the two are compared.  Losses
and predictions are held with ``allclose`` at rtol 1e-5, atol 1e-6: the
same f32 arithmetic up to summation order over a dozen SGD steps of a
13-1 fc.  A resumed state is held bitwise: it is read from the same shard
files.
"""

import faulthandler
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.dataset import uci_housing as juci
from paddle_tpu.distributed import elastic as jelastic
from paddle_tpu_torch.distributed import elastic as telastic

TOL = dict(rtol=1e-5, atol=1e-6)
TIME_LIMIT_S = 120
PKGS = {'jax': jfluid, 'torch': tfluid}


@pytest.fixture(autouse=True)
def _names_and_time_limit():
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    try:
        with jfluid.unique_name.guard(), tfluid.unique_name.guard():
            yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def _train_func(fluid):
    def train_func():
        x = fluid.layers.data('x', [13])
        y = fluid.layers.data('y', [1])
        pred = fluid.layers.fc(x, 1, name='uci_fc')
        return [fluid.layers.mean(fluid.layers.square_error_cost(pred, y))]
    return train_func


def _trainer(pkg, start=None, cfg=None):
    """A Trainer of ``pkg`` on the CPU, named afresh; the port's takes the
    ``start`` state (the JAX package's startup values) when given."""
    fluid = PKGS[pkg]
    with fluid.unique_name.guard():
        tr = fluid.Trainer(_train_func(fluid),
                           lambda: fluid.optimizer.SGD(learning_rate=0.01),
                           place=fluid.CPUPlace(), checkpoint_config=cfg)
    if start is not None:
        for name, arr in start.items():
            tr.scope.var(name).set_value(torch.tensor(arr))
    return tr


def _state(pkg, tr):
    """{name: array} of the trainer's persistable tensors."""
    out = {}
    for v in tr.train_program.list_vars():
        var = tr.scope.find_var(v.name) if v.persistable else None
        if var is None or var.value() is None:
            continue
        val = var.value()
        out[v.name] = (np.array(jfluid.executor.as_numpy(val))
                       if pkg == 'jax' else
                       (val.tensor() if isinstance(val, tfluid.LoDTensor)
                        else val).numpy())
    return out


def _uci_reader(seed_rows=64, batch=16):
    data = list(juci.train(seed_rows)())

    def batch_reader():
        for i in range(0, seed_rows, batch):
            yield data[i:i + batch]
    return batch_reader


def _train(tr, epochs, reader, spd=1, handler=None):
    fluid = tfluid if isinstance(tr, tfluid.Trainer) else jfluid
    losses = []

    def on_event(e):
        if isinstance(e, fluid.EndStepEvent):
            losses.append(float(np.asarray(e.metrics[0]).reshape(-1)[0]))
        if handler is not None:
            handler(e)

    tr.train(num_epochs=epochs, event_handler=on_event, reader=reader,
             feed_order=['x', 'y'], steps_per_dispatch=spd)
    return losses


def test_trainer_inferencer_roundtrip_like_jax(tmp_path):
    """Three epochs of uci_housing through the Trainer event loop, the
    loss falling; save_params; an Inferencer on the saved params predicts
    [4, 1].  The port's losses equal the JAX package's, and both
    packages' Inferencers predict the same from the port's params."""
    jtr = _trainer('jax')
    start = _state('jax', jtr)
    ttr = _trainer('torch', start)
    losses = {pkg: _train(tr, 3, _uci_reader())
              for pkg, tr in (('jax', jtr), ('torch', ttr))}
    assert len(losses['torch']) == 12
    assert losses['torch'][-1] < losses['torch'][0]
    np.testing.assert_allclose(losses['torch'], losses['jax'], **TOL)
    param_dir = str(tmp_path / 'params')
    ttr.save_params(param_dir)
    x = np.random.RandomState(4).rand(4, 13).astype('float32')
    outs = {}
    for pkg, fluid in PKGS.items():
        def infer_func(fluid=fluid):
            xv = fluid.layers.data('x', [13])
            return fluid.layers.fc(xv, 1, name='uci_fc')

        with fluid.unique_name.guard():
            inferencer = fluid.Inferencer(infer_func=infer_func,
                                          param_path=param_dir,
                                          place=fluid.CPUPlace())
        outs[pkg] = np.asarray(inferencer.infer({'x': x})[0])
    assert outs['torch'].shape == (4, 1)
    np.testing.assert_allclose(outs['torch'], outs['jax'], **TOL)


@pytest.mark.parametrize('writer,reader', [('jax', 'torch'),
                                           ('torch', 'jax')])
def test_checkpoint_resumes_across_packages(tmp_path, writer, reader):
    """A Trainer of ``writer``'s package checkpoints every step of an
    epoch; a Trainer of ``reader``'s resumes from the newest manifest with
    the same state, bitwise, the same serial and position; a second epoch
    from there matches the writer's own second epoch."""
    ckpt = str(tmp_path / 'ckpt')
    start = _state('jax', _trainer('jax'))
    cfg = lambda: PKGS[writer].CheckpointConfig(ckpt, step_interval=1,
                                                max_num_checkpoints=2)
    wtr = _trainer(writer, start if writer == 'torch' else None, cfg())
    _train(wtr, 1, _uci_reader())
    saved = _state(writer, wtr)
    rcfg = PKGS[reader].CheckpointConfig(ckpt, step_interval=1,
                                         max_num_checkpoints=2)
    rtr = _trainer(reader, None, rcfg)
    assert (rcfg.load_serial, rcfg.epoch_id, rcfg.step_id) == (4, 0, 3)
    loaded = _state(reader, rtr)
    assert sorted(loaded) == sorted(saved)
    for name in saved:
        np.testing.assert_array_equal(loaded[name], saved[name], err_msg=name)
    more_w = _train(wtr, 1, _uci_reader())
    more_r = _train(rtr, 1, _uci_reader())
    np.testing.assert_allclose(more_r, more_w, **TOL)
    manifests = sorted(f for f in os.listdir(ckpt)
                       if f.startswith('MANIFEST-'))
    assert len(manifests) == 2  # max_num_checkpoints


def test_pipelined_trainer_stopped_and_resumed_equals_uninterrupted(
        tmp_path):
    """A pipelined Trainer (steps_per_dispatch=2) stopped by an exception
    at the start of its second epoch and resumed by a new Trainer from its
    checkpoint ends with the state of an uninterrupted two-epoch run
    (bitwise on the CPU), in the port."""
    class Killed(Exception):
        pass

    def kill(e):
        if isinstance(e, tfluid.BeginEpochEvent) and e.epoch == 1:
            raise Killed()

    start = _state('jax', _trainer('jax'))
    whole = _trainer('torch', start)
    _train(whole, 2, _uci_reader(), spd=2)
    ckpt = str(tmp_path / 'ckpt')
    first = _trainer('torch', start, tfluid.CheckpointConfig(
        ckpt, step_interval=1))
    with pytest.raises(Killed):
        _train(first, 2, _uci_reader(), spd=2, handler=kill)
    cfg = tfluid.CheckpointConfig(ckpt, step_interval=1)
    resumed = _trainer('torch', None, cfg)
    assert (cfg.epoch_id, cfg.step_id) == (0, 1)
    _train(resumed, 1, _uci_reader(), spd=2)
    want, got = _state('torch', whole), _state('torch', resumed)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize('saver', ['jax', 'torch'])
def test_pre_manifest_checkpoint_resumes_then_is_superseded(tmp_path, saver):
    """A checkpoint of the earlier layout, <dir>/<serial>/ with a file a
    var (save_persistables of ``saver``'s package), resumes in the port's
    Trainer; once train() has committed a manifest the old tree goes."""
    ckpt = str(tmp_path / 'ckpt')
    tr = _trainer(saver, _state('jax', _trainer('jax'))
                  if saver == 'torch' else None)
    _train(tr, 1, _uci_reader())
    with PKGS[saver].scope_guard(tr.scope):
        PKGS[saver].io.save_persistables(tr.exe, os.path.join(ckpt, '7'),
                                         main_program=tr.train_program)
    saved = _state(saver, tr)
    cfg = tfluid.CheckpointConfig(ckpt, step_interval=1)
    resumed = _trainer('torch', None, cfg)
    assert cfg.load_serial == 7
    loaded = _state('torch', resumed)
    for name in saved:
        np.testing.assert_array_equal(loaded[name], saved[name], err_msg=name)
    _train(resumed, 1, _uci_reader())
    assert not os.path.exists(os.path.join(ckpt, '7'))
    assert any(f.startswith('MANIFEST-') for f in os.listdir(ckpt))


def test_async_sharded_checkpoint_like_jax(tmp_path):
    """The store's retention, manifest and shard bytes against the JAX
    package's on the same arrays, and a failing writer: CheckpointWriteError
    once from wait(), then nothing."""
    rng = np.random.RandomState(0)
    steps = [{'w': rng.rand(3, 4).astype('float32'),
              'step@COUNTER': np.array([s], np.int64)} for s in range(4)]
    seen = {}
    for pkg, mod in (('jax', jelastic), ('torch', telastic)):
        d = str(tmp_path / pkg)
        store = mod.AsyncShardedCheckpoint(d, keep=2)
        commits = []
        for s, arrays in enumerate(steps):
            store.save(s, arrays, extras={'epoch': 0, 'step': s},
                       on_commit=commits.append, wait=True)
        manifest = store.latest()
        step, arrays, extras = store.load()
        shard_bytes = {n: open(os.path.join(d, *rel.split('/')), 'rb').read()
                       for n, rel in manifest['shards'].items()}
        store.close()
        seen[pkg] = dict(
            manifests=sorted(f for f in os.listdir(d)
                             if f.startswith('MANIFEST-')),
            shards=sorted(os.listdir(os.path.join(d, 'shards'))),
            manifest={k: manifest[k] for k in ('fmt', 'version', 'step',
                                               'shards', 'bytes', 'extras')},
            loaded=(step, {n: np.asarray(a).tolist()
                           for n, a in arrays.items()}, extras),
            commits=commits, shard_bytes=shard_bytes,
            active=os.path.exists(os.path.join(d, 'ACTIVE')))
    assert seen['torch'] == seen['jax']
    assert seen['torch']['manifests'] == ['MANIFEST-000000000002.json',
                                          'MANIFEST-000000000003.json']
    # a writer that cannot write: the error comes once, typed
    raised = {}
    for pkg, mod in (('jax', jelastic), ('torch', telastic)):
        d = str(tmp_path / ('bad_' + pkg))
        store = mod.AsyncShardedCheckpoint(d, keep=1)
        os.rmdir(os.path.join(d, 'shards'))
        open(os.path.join(d, 'shards'), 'w').close()  # blocks the shard dir
        store.save(0, steps[0])
        with pytest.raises(mod.CheckpointWriteError) as ei:
            store.wait()
        store.wait()  # delivered once
        raised[pkg] = type(ei.value.__cause__).__name__
        store.close()
    assert raised['torch'] == raised['jax']
    with open(os.path.join(str(tmp_path / 'torch'),
                           seen['torch']['manifests'][-1])) as f:
        assert json.load(f)['fmt'] == 'paddle-tpu-elastic-manifest'

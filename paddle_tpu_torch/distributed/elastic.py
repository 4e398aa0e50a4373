"""The checkpoint store of elastic training (counterpart of the
checkpoint part of ``paddle_tpu/distributed/elastic.py``): per-var shard
files in the LoDTensor format, an atomic manifest commit, bounded
retention, and the write on a background thread, so that a training loop
never waits on checkpoint IO.  A checkpoint written by either package
resumes in the other: the layout, the manifest and the shard bytes are
the JAX package's.

Not ported yet: ``ElasticTrainJob`` (ROADMAP.md, Queue 1 item 9).
"""

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

__all__ = ['AsyncShardedCheckpoint', 'CheckpointWriteError']

MANIFEST_FMT = 'paddle-tpu-elastic-manifest'
MANIFEST_VERSION = 1
_MANIFEST_PREFIX = 'MANIFEST-'
_SHARDS_DIR = 'shards'
# liveness marker: written at store open, removed at close;
# AsyncShardedCheckpoint.gc() never touches a directory that holds one
_ACTIVE_MARKER = 'ACTIVE'


def _host_copy(value):
    """A host copy of a checkpointed value (a torch tensor, on any device,
    or anything numpy reads) as a CPU tensor of its own."""
    if isinstance(value, torch.Tensor):
        return value.detach().to('cpu', copy=True)
    return torch.from_numpy(np.array(value, copy=True))


class CheckpointWriteError(RuntimeError):
    """The background checkpoint writer failed; raised (once) from
    ``wait()``/``close()`` so a silent writer death cannot masquerade
    as durability."""


def _save_shard(path, arr):
    from ..fluid import io as fluid_io
    fluid_io._save_one(path, arr)


def _load_shard(path):
    from ..fluid import io as fluid_io
    return fluid_io._load_one(path)


class AsyncShardedCheckpoint(object):
    """Sharded checkpoint store with async writes, atomic manifest
    commit and bounded retention.

    Layout under ``directory``::

        MANIFEST-<step>.json        # commit point (tmp + os.replace)
        shards/<step>/<var_name>    # one LoDTensor-format file per var

    ``save(step, arrays, extras)`` enqueues HOST arrays for a
    background writer (latest-wins: a save landing while the previous
    one is still writing REPLACES it and counts a ``stall`` — the step
    loop never blocks on checkpoint IO).  The manifest is written only
    after every shard landed, via tmp + rename, so a crash mid-write
    leaves a ``.tmp`` shard dir and no manifest — swept (with every
    other orphan) on open and after each retention prune: no manifest
    ever references a missing shard, and no shard file outlives its
    manifest.

    ``sync=True`` writes inline on the caller thread."""

    def __init__(self, directory, keep=3, sync=False):
        self.directory = directory
        self.keep = max(int(keep), 1)
        self.sync = bool(sync)
        os.makedirs(os.path.join(directory, _SHARDS_DIR), exist_ok=True)
        self._cond = threading.Condition()
        self._pending = None
        self._busy_since = None
        self._thread = None
        self._closed = False
        self._error = None
        self._m = {'saves': 0, 'stalls': 0, 'errors': 0,
                   'bytes_written': 0, 'last_step': None,
                   'last_commit_t': None}
        with open(os.path.join(directory, _ACTIVE_MARKER), 'w') as f:
            json.dump({'pid': os.getpid(), 'opened_t': time.time()}, f)
        self._sweep()  # crashed-write hygiene from a previous life

    # ---- paths ---------------------------------------------------------

    def _manifest_path(self, step):
        return os.path.join(self.directory,
                            '%s%012d.json' % (_MANIFEST_PREFIX, step))

    def _shard_dir(self, step):
        return os.path.join(self.directory, _SHARDS_DIR, '%012d' % step)

    def _manifest_steps(self):
        out = []
        for f in os.listdir(self.directory):
            if f.startswith(_MANIFEST_PREFIX) and f.endswith('.json'):
                try:
                    out.append(int(f[len(_MANIFEST_PREFIX):-5]))
                except ValueError:
                    continue
        return sorted(out)

    # ---- write side ----------------------------------------------------

    def save(self, step, arrays, extras=None, wait=False,
             on_commit=None):
        """Checkpoint ``arrays`` (name -> tensor or array) at ``step``.
        Host copies are taken HERE, synchronously — after ``save``
        returns the caller may mutate the device buffers freely (the next
        replay overwrites them); only the serialization + disk write is
        deferred to the writer thread.  ``extras`` must be
        JSON-serializable.  ``on_commit(step)`` runs right after the
        manifest commit (on the writer thread; inline for a sync store):
        work is reported finished only once its covering state is
        durable.
        A latest-wins-replaced save's callback is NOT invoked; the
        newer save's commit covers it."""
        if self._closed:
            raise CheckpointWriteError('checkpoint store is closed')
        item = (int(step), {n: _host_copy(a) for n, a in arrays.items()},
                dict(extras or {}), on_commit)
        if self.sync:
            self._write(item)
            if on_commit is not None:
                on_commit(int(step))
            return
        with self._cond:
            if self._closed:
                raise CheckpointWriteError('checkpoint store is closed')
            if self._pending is not None:
                # latest-wins: never block the step loop, never queue
                # unboundedly — the dropped save is a counted stall
                self._m['stalls'] += 1
            self._pending = item
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._writer_loop,
                    name='ckpt-writer-%s' % os.path.basename(
                        self.directory.rstrip(os.sep)),
                    daemon=True)
                self._thread.start()
            self._cond.notify_all()
        if wait:
            self.wait()

    # an idle writer retires after this long; the next save() simply
    # starts a fresh one — so N short-lived checkpointing objects (e.g.
    # Trainers in a sweep) never accumulate N parked threads
    IDLE_EXIT_S = 5.0

    def _writer_loop(self):
        idle_deadline = time.time() + self.IDLE_EXIT_S
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    if time.time() >= idle_deadline:
                        self._thread = None  # save() restarts us
                        return
                    self._cond.wait(0.1)
                if self._pending is None and self._closed:
                    return
                item, self._pending = self._pending, None
                self._busy_since = time.time()
            try:
                self._write(item)
                if item[3] is not None:
                    # the commit callback runs BEFORE the busy flag
                    # clears, so wait() returning implies callbacks ran
                    item[3](item[0])
            except BaseException as e:  # surfaced by wait()/close()
                self._error = e
                self._m['errors'] += 1
            finally:
                with self._cond:
                    self._busy_since = None
                    self._cond.notify_all()
            idle_deadline = time.time() + self.IDLE_EXIT_S

    def _write(self, item):
        step, arrays, extras = item[0], item[1], item[2]
        sdir = self._shard_dir(step)
        tmp = sdir + '.tmp'
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        shards, nbytes = {}, 0
        for name, arr in arrays.items():
            # var names may contain '/'-unsafe chars only in exotic
            # programs; keep the flat name (the manifest records it)
            _save_shard(os.path.join(tmp, name), arr)
            shards[name] = '%s/%012d/%s' % (_SHARDS_DIR, step, name)
            nbytes += int(arr.numel() * arr.element_size())
        if os.path.isdir(sdir):
            # re-commit of the same step (e.g. the final checkpoint at
            # a step a periodic save already committed): retract the
            # MANIFEST FIRST so a crash inside this window leaves "no
            # manifest for this step" (resume falls back to the
            # previous retained manifest) — never a committed manifest
            # pointing at deleted shards
            mpath = self._manifest_path(step)
            if os.path.exists(mpath):
                os.remove(mpath)
            shutil.rmtree(sdir)
        os.replace(tmp, sdir)
        manifest = {
            'fmt': MANIFEST_FMT, 'version': MANIFEST_VERSION,
            'step': step, 'shards': shards, 'bytes': nbytes,
            'time': time.time(), 'extras': extras,
        }
        mpath = self._manifest_path(step)
        mtmp = mpath + '.tmp'
        with open(mtmp, 'w') as f:
            json.dump(manifest, f)
        os.replace(mtmp, mpath)  # the atomic commit point
        self._m['saves'] += 1
        self._m['bytes_written'] += nbytes
        self._m['last_step'] = step
        self._m['last_commit_t'] = time.time()
        self._sweep()

    def _sweep(self):
        """Retention + hygiene: keep the newest ``keep`` manifests;
        remove pruned manifests FIRST, then their shard dirs; then
        sweep every orphan — shard dirs without a live manifest
        (crashed prune), ``.tmp`` shard dirs and manifest tmps
        (crashed write)."""
        steps = self._manifest_steps()
        for step in steps[:-self.keep]:
            try:
                os.remove(self._manifest_path(step))
            except OSError:
                pass
        live = set(steps[-self.keep:])
        shards_root = os.path.join(self.directory, _SHARDS_DIR)
        for d in os.listdir(shards_root):
            base = d[:-4] if d.endswith('.tmp') else d
            try:
                step = int(base)
            except ValueError:
                step = None
            if d.endswith('.tmp') or step is None or step not in live:
                shutil.rmtree(os.path.join(shards_root, d),
                              ignore_errors=True)
        for f in os.listdir(self.directory):
            if f.startswith(_MANIFEST_PREFIX) and f.endswith('.json.tmp'):
                try:
                    os.remove(os.path.join(self.directory, f))
                except OSError:
                    pass

    # ---- read side -----------------------------------------------------

    def latest(self):
        """The newest committed manifest dict, or None."""
        steps = self._manifest_steps()
        if not steps:
            return None
        with open(self._manifest_path(steps[-1])) as f:
            return json.load(f)

    def load(self, manifest=None):
        """(step, {name: CPU tensor}, extras) for ``manifest`` (default:
        newest)."""
        manifest = manifest if manifest is not None else self.latest()
        if manifest is None:
            raise CheckpointWriteError(
                'no committed checkpoint manifest under %s'
                % self.directory)
        arrays = {
            name: _load_shard(os.path.join(self.directory,
                                           *rel.split('/')))
            for name, rel in manifest['shards'].items()
        }
        return int(manifest['step']), arrays, dict(
            manifest.get('extras') or {})

    # ---- lifecycle / observability -------------------------------------

    def pending_age(self):
        """Seconds the writer has been busy on the CURRENT write (None
        when idle) — the watchdog's checkpoint-stall probe."""
        since = self._busy_since
        return (time.time() - since) if since is not None else None

    def wait(self, timeout=30.0):
        """Block until the writer drained (pending save committed);
        raises CheckpointWriteError if the writer failed."""
        deadline = time.time() + timeout
        with self._cond:
            while (self._pending is not None or
                   self._busy_since is not None):
                left = deadline - time.time()
                if left <= 0:
                    raise CheckpointWriteError(
                        'checkpoint writer did not drain in %.1fs'
                        % timeout)
                self._cond.wait(min(left, 0.1))
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointWriteError(
                'checkpoint write failed: %r' % (err, )) from err

    def metrics(self):
        m = dict(self._m)
        m['pending'] = self._pending is not None
        m['writing'] = self._busy_since is not None
        last = m['last_commit_t']
        m['age_s'] = (time.time() - last) if last else None
        return m

    @classmethod
    def gc(cls, root, keep_jobs=2, keep_hours=None):
        """Cross-job retention: ``root`` holds one checkpoint directory
        per job (the per-job stores already bound their own step
        retention with ``keep=``; what grows without bound is the number
        of FINISHED jobs).  Removes dead job dirs — committed manifests,
        shards and all — keeping the newest ``keep_jobs`` of them by
        last-manifest mtime.  ``keep_hours`` adds an age-based sweep on
        top of the count-based one: a dead store whose newest manifest is older
        than ``keep_hours`` hours is removed even when the
        ``keep_jobs`` count would have retained it.  Never touched:
        dirs carrying the ``ACTIVE`` marker (a live store; a crashed
        job's stale marker is the operator's to clear) and dirs that
        don't look like checkpoint stores at all (no manifests, no
        shards/).  Returns the removed paths."""
        if int(keep_jobs) < 0:
            raise ValueError('gc: keep_jobs must be >= 0')
        if keep_hours is not None and float(keep_hours) < 0:
            raise ValueError('gc: keep_hours must be >= 0')
        dead = []
        for name in sorted(os.listdir(root)):
            d = os.path.join(root, name)
            if not os.path.isdir(d):
                continue
            try:
                entries = os.listdir(d)
            except OSError:
                continue
            manifests = [f for f in entries
                         if f.startswith(_MANIFEST_PREFIX)
                         and f.endswith('.json')]
            if not manifests and _SHARDS_DIR not in entries:
                continue  # not a checkpoint store: never touch
            if _ACTIVE_MARKER in entries:
                continue  # live job: never touch
            newest = max([os.path.getmtime(os.path.join(d, f))
                          for f in manifests] or
                         [os.path.getmtime(d)])
            dead.append((newest, d))
        dead.sort()
        doomed = set(
            d for _, d in dead[:max(0, len(dead) - int(keep_jobs))])
        if keep_hours is not None:
            cutoff = time.time() - float(keep_hours) * 3600.0
            doomed.update(d for newest, d in dead if newest < cutoff)
        removed = []
        for _, d in dead:
            if d not in doomed:
                continue
            shutil.rmtree(d, ignore_errors=True)
            removed.append(d)
        return removed

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        try:
            os.remove(os.path.join(self.directory, _ACTIVE_MARKER))
        except OSError:
            pass
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointWriteError(
                'checkpoint write failed: %r' % (err, )) from err



"""Generation serving: the slot-based decode-state cache and its request
and spec types.

Counterpart of ``paddle_tpu/serving/decode.py``.  The reference serves
generation one graph call per decode step per request; the engine's decode
lane amortizes that the way ``run_multi`` amortizes training steps, with
three pieces living here:

  * **GenerationSpec**: the model contract, a PREFILL program (prompt
    feeds -> initial per-request decoder state) and a STEP program
    (current token + state -> next-token logits + next state), wired by
    name, and optionally a CHUNK program (a C-token block of the prompt
    advancing the state in place).  The step program must be
    row-independent, so a batched slot dispatch is token-identical to
    per-request decode.
  * **SlotStateCache**: S fixed slots of decoder state, one [S, ...] slab
    per state and context feed, plus the per-slot token, alive and
    step-budget leaves the decode loop carries.  Requests ADMIT into free
    slots at step boundaries and RELEASE on finish (continuous batching).
    Under chunked prefill a slot can also be PREFILLING: zeroed slabs and
    a host-side position cursor, inert in decode steps (alive False) while
    chunk dispatches advance the partial state; the finishing chunk flips
    the slot to decoding on the device.  The leaves start as host arrays;
    after the first decode dispatch they are the captured step's own
    buffers on the card, and admission writes rows into them in place
    (``index_copy_``, on the stream the worker replays on).  The cache is
    an ``HBMArbiter`` account in the registry (``<model>:decode-cache``):
    ``to_host`` demotes it bit for bit and the next dispatch stages it
    back.
  * **GenerationRequest**: the future ``submit_generate`` returns; it
    resolves to the generated token ids (EOS-terminated or cut at
    ``max_len``).
"""

import threading

import numpy as np
import torch

from ..fluid.executor import upload
from ..ops import registry
from .batcher import InferenceRequest

__all__ = ['GenerationSpec', 'SlotStateCache', 'GenerationRequest']


def _has_host_ops(program):
    return any(registry.is_host_op_type(op.type)
               for op in program.global_block().ops)


def _slot_shape(program, name, what):
    """The per-slot (batch-free) shape and numpy dtype a step-program feed
    declares.  Slot state must be statically shaped: the cache is one
    resident [S, ...] slab per feed."""
    var = program.global_block().vars.get(name)
    if var is None:
        raise ValueError('%s: %r is not a variable of the step program'
                         % (what, name))
    shape = tuple(var.shape)
    trailing = tuple(int(d) for d in shape[1:])
    if any(d < 0 for d in trailing):
        raise ValueError(
            '%s: feed %r declares a dynamic non-batch dim %s — slot '
            'state needs a static per-slot shape (size the cache axis, '
            'e.g. the KV length, to its maximum)' % (what, name, shape))
    return trailing, var.np_dtype


class GenerationSpec(object):
    """The generation model contract the engine's decode lane serves.

    prefill_program: prompt feeds -> the initial per-request decoder
        state, ONE fetch per ``state`` + ``context`` feed (in that order).
        Served through the engine's lot machinery, so prompts micro-batch,
        shape-bucket and ride the trailing-dim ladder.
    step_program: ``token_feed`` + state/context feeds -> ``logits``
        (argmax = next token, greedy) + one fetch per ``state`` feed.
        Host-op free and row-independent.
    state: ordered (step_feed_name, step_fetch_var) pairs: the decoder
        state that updates every step.
    context: step feed names that are per-request but frozen during
        decode (encoder outputs); their initial values come from the
        prefill fetches after the state ones.
    start_id / end_id: BOS fed at the first step / the EOS stop condition.
    max_len: default (and cap for) the per-request generation budget.
    prompt_feed / prompt_len_feed: the prefill feed carrying the prompt
        tokens and its dense length feed; max_ctx the decode context bound
        (a prompt, or prompt + budget, past it is rejected at submit).
    chunk_program / chunk_token / chunk_len / chunk_state / chunk_width:
        the chunked-prefill contract (``build_step_decode(chunk=C)``).

    Prefill fetches may be narrower than the slot shape on trailing axes
    (a prompt's KV prefix against the full cache length): admission
    zero-pads them up to the slab.
    """

    def __init__(self, prefill_program, step_program, prefill_feeds,
                 prefill_fetches, token_feed, logits, state,
                 context=(), start_id=0, end_id=1, max_len=32,
                 prompt_feed=None, prompt_len_feed=None, max_ctx=None,
                 chunk_program=None, chunk_token=None, chunk_len=None,
                 chunk_state=None, chunk_width=None):
        self.prefill_program = prefill_program
        self.step_program = step_program
        self.prefill_feeds = list(prefill_feeds)
        self.prefill_fetches = list(prefill_fetches)
        self.token_feed = str(token_feed)
        self.logits = logits
        if isinstance(state, dict):
            state = list(state.items())
        self.state = [(str(n), v) for n, v in state]
        self.context = [str(n) for n in context]
        self.start_id = int(start_id)
        self.end_id = int(end_id)
        self.max_len = int(max_len)
        if self.max_len < 1:
            raise ValueError('GenerationSpec: max_len must be >= 1')
        if not self.state:
            raise ValueError(
                'GenerationSpec: at least one state pair is required — '
                'a stateless step function has nothing to carry across '
                'decode steps')
        self.slot_feeds = [n for n, _ in self.state] + self.context
        if len(self.prefill_fetches) != len(self.slot_feeds):
            raise ValueError(
                'GenerationSpec: prefill_fetches (%d) must align with '
                'the state + context feeds (%d: %s) — one initial value '
                'each, in order' % (len(self.prefill_fetches),
                                    len(self.slot_feeds),
                                    self.slot_feeds))
        for prog, label in ((prefill_program, 'prefill_program'),
                            (step_program, 'step_program')):
            if _has_host_ops(prog):
                raise ValueError(
                    'GenerationSpec: %s contains host ops and cannot '
                    'run inside the decode lane' % label)
        # per-slot slab shapes and dtypes, from the step program's feed
        # declarations (they key the cache allocation and the admission
        # padding)
        self.slot_shapes = {}
        self.slot_dtypes = {}
        for name in self.slot_feeds + [self.token_feed]:
            shape, dtype = _slot_shape(step_program, name,
                                       'GenerationSpec')
            self.slot_shapes[name] = shape
            self.slot_dtypes[name] = dtype
        self.prompt_feed = (str(prompt_feed)
                            if prompt_feed is not None else None)
        self.prompt_len_feed = (str(prompt_len_feed)
                                if prompt_len_feed is not None else None)
        self.max_ctx = int(max_ctx) if max_ctx is not None else None
        self.chunk_program = chunk_program
        self.chunk_token = (str(chunk_token)
                            if chunk_token is not None else None)
        self.chunk_len = str(chunk_len) if chunk_len is not None else None
        if isinstance(chunk_state, dict):
            chunk_state = list(chunk_state.items())
        self.chunk_state = ([(str(n), v) for n, v in chunk_state]
                            if chunk_state is not None else None)
        self.chunk_width = (int(chunk_width)
                            if chunk_width is not None else None)
        if chunk_program is not None:
            self._check_chunk(chunk_program)

    def _check_chunk(self, chunk_program):
        if self.chunk_token is None or self.chunk_state is None or \
                self.chunk_width is None:
            raise ValueError(
                'GenerationSpec: a chunk program needs chunk_token, '
                'chunk_state and chunk_width alongside it')
        if self.prompt_feed is None:
            raise ValueError(
                'GenerationSpec: chunked prefill needs prompt_feed — the '
                'engine must slice the raw token sequence into chunk '
                'blocks')
        if self.context:
            raise ValueError(
                'GenerationSpec: chunked prefill does not support context '
                'feeds — a chunk advances only the decode STATE slabs, so '
                'frozen per-request context has no chunk to initialize it')
        if [n for n, _ in self.chunk_state] != [n for n, _ in self.state]:
            raise ValueError(
                'GenerationSpec: chunk_state must advance exactly the '
                'decode state feeds, in order (%s vs %s)'
                % ([n for n, _ in self.chunk_state],
                   [n for n, _ in self.state]))
        if _has_host_ops(chunk_program):
            raise ValueError(
                'GenerationSpec: chunk_program contains host ops and '
                'cannot run inside the decode lane')
        from ..fluid.shape_policy import bucketed_len
        if bucketed_len(self.chunk_width) != self.chunk_width:
            raise ValueError(
                'GenerationSpec: chunk_width %d is not a seq-len ladder '
                'rung — build the model with a rung-quantized chunk '
                '(shape_policy.bucketed_len)' % self.chunk_width)
        for name, _ in self.state:
            shape, dtype = _slot_shape(chunk_program, name,
                                       'GenerationSpec chunk')
            if shape != self.slot_shapes[name] or \
                    dtype != self.slot_dtypes[name]:
                raise ValueError(
                    'GenerationSpec: chunk program declares state feed %r '
                    'as %s %s, step program as %s %s — the chunk must '
                    'advance the SAME slabs'
                    % (name, shape, dtype, self.slot_shapes[name],
                       self.slot_dtypes[name]))

    @property
    def supports_chunked_prefill(self):
        return self.chunk_program is not None

    def chunk_arg(self):
        """The ``chunk=`` dict of the executor's chunk dispatch."""
        return {'token': self.chunk_token, 'len': self.chunk_len,
                'state': list(self.chunk_state),
                'start_id': self.start_id}

    def prompt_ids(self, feed):
        """(token ids [L] int64, L) of one request's prompt, read from the
        submitted feed: an LoD prompt carries its length in the LoD, a
        dense one in ``prompt_len_feed`` (else its full padded extent)."""
        if self.prompt_feed is None:
            raise ValueError(
                'GenerationSpec: no prompt_feed declared — the model '
                'dict must name which prefill feed carries the prompt '
                'tokens')
        from ..fluid import core

        def host(v):
            if isinstance(v, core.LoDTensor):
                v = v.tensor()
            if isinstance(v, torch.Tensor):
                return v.detach().cpu().numpy()
            return np.asarray(v)

        v = feed[self.prompt_feed]
        if isinstance(v, core.LoDTensor) and v.lod():
            ids = host(v).reshape(-1)
            return ids.astype(np.int64), int(ids.shape[0])
        flat = host(v).reshape(-1)
        length = int(flat.shape[0])
        if self.prompt_len_feed is not None and \
                self.prompt_len_feed in feed:
            length = int(host(feed[self.prompt_len_feed]).reshape(-1)[0])
        return flat[:length].astype(np.int64), length

    @classmethod
    def from_model(cls, model, max_len=None):
        """A spec from the dict the model zoo's ``build_step_decode``
        returns (and, for a model built with ``chunk=C``, its chunk
        program)."""
        return cls(model['prefill'], model['step'],
                   model['prefill_feeds'], model['prefill_fetches'],
                   model['token'], model['logits'], model['state'],
                   context=model.get('context', ()),
                   start_id=model['start_id'], end_id=model['end_id'],
                   max_len=(model['max_len'] if max_len is None
                            else max_len),
                   prompt_feed=model.get('prompt'),
                   prompt_len_feed=model.get('prompt_len'),
                   max_ctx=model.get('max_ctx'),
                   chunk_program=model.get('chunk'),
                   chunk_token=model.get('chunk_token'),
                   chunk_len=model.get('chunk_len'),
                   chunk_state=model.get('chunk_state'),
                   chunk_width=model.get('chunk_width'))

    def decode_arg(self):
        """The ``decode=`` dict of ``Executor.run_decode_multi``."""
        return {'token': self.token_feed, 'logits': self.logits,
                'state': list(self.state), 'context': list(self.context),
                'end_id': self.end_id}

    def cache_nbytes(self, slots):
        """The slot cache's device bytes at ``slots`` slots, known before
        it is allocated (the arbiter's admission seed for the
        ``<model>:decode-cache`` account)."""
        total = 0
        for name in self.slot_feeds:
            shape = (int(slots), ) + self.slot_shapes[name]
            total += int(np.prod(shape)) * \
                np.dtype(self.slot_dtypes[name]).itemsize
        # token [S, 1] + alive [S] + remaining [S]
        total += int(slots) * (
            np.dtype(self.slot_dtypes[self.token_feed]).itemsize + 1 + 4)
        return total


class GenerationRequest(InferenceRequest):
    """One ``submit_generate`` future: resolves to the generated token ids
    (int64 ndarray; EOS-terminated, or cut at ``max_len``).  The prompt
    rides a prefill lot like a forward request; then the request occupies
    ONE decode slot until its stop condition masks it out."""

    kind = 'generate'

    def __init__(self, feed, rows, sig, max_len, return_numpy=True,
                 trace=None, priority=0, deadline_ms=None):
        super(GenerationRequest, self).__init__(
            feed, rows, sig, return_numpy=return_numpy, trace=trace,
            priority=priority, deadline_ms=deadline_ms)
        self.max_len = int(max_len)
        self.tokens = []
        self.slot = None
        # chunked prefill: the raw prompt tokens the engine slices into
        # C-token blocks, and the phase flag
        self.prompt_tokens = None
        self.prompt_len = None
        self.prefilling = False


def _nbytes(arr):
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(getattr(arr, 'nbytes', 0))


class SlotStateCache(object):
    """S fixed decode slots: one [S, ...] slab per state/context feed plus
    the loop's carry leaves (token/alive/remaining).  Slot ADMISSION writes
    a request's prefilled state into a free row (zero-padding narrow
    trailing axes up to the slab); RELEASE frees the row for the next
    admission, both at step boundaries.

    The leaves are swapped whole by the owning engine's decode cycle (one
    worker thread, or the inline lock) and written row by row in place;
    the small host-side slot map is lock-guarded so that the watchdog's
    snapshot can race a cycle."""

    def __init__(self, spec, slots, multiple=1):
        if int(slots) < 1:
            raise ValueError('SlotStateCache: slots must be >= 1')
        multiple = max(int(multiple), 1)
        self.slots = -(-int(slots) // multiple) * multiple
        self.spec = spec
        self._lock = threading.Lock()
        self._init_state()

    def _init_state(self):
        """Fresh host-side slabs and carry leaves and an all-free slot map
        (construction and reset() share it)."""
        s = self.slots
        spec = self.spec
        self._slabs = {
            name: np.zeros((s, ) + spec.slot_shapes[name],
                           spec.slot_dtypes[name])
            for name in spec.slot_feeds
        }
        self._token = np.full((s, 1), spec.end_id,
                              spec.slot_dtypes[spec.token_feed])
        self._alive = np.zeros((s, ), bool)
        self._remaining = np.zeros((s, ), np.int32)
        with self._lock:
            self._requests = [None] * s
            self._free = list(range(s))
            # chunked prefill: slot -> prompt cursor of PREFILLING slots
            self._prefill = {}

    # ---- carry plumbing (the decode loop's view) -----------------------

    def carry(self):
        return {'slots': dict(self._slabs), 'token': self._token,
                'alive': self._alive, 'remaining': self._remaining}

    def set_carry(self, carry):
        self._slabs = dict(carry['slots'])
        self._token = carry['token']
        self._alive = carry['alive']
        self._remaining = carry['remaining']

    # ---- admission / release -------------------------------------------

    def free_slots(self):
        with self._lock:
            return len(self._free)

    def active_slots(self):
        with self._lock:
            return self.slots - len(self._free)

    def any_active(self):
        return self.active_slots() > 0

    @staticmethod
    def _write_row(arr, idx, row):
        """Row ``idx`` of a leaf set to ``row``: a host array in place (a
        copy first where it is read-only), a tensor in place by
        ``index_copy_`` on its device, the row and its index uploaded
        behind the work queued there (no host sync)."""
        if isinstance(arr, torch.Tensor):
            src = upload(np.asarray(row), arr.device, arr.dtype)
            index = upload(np.asarray([int(idx)], np.int64), arr.device)
            arr.index_copy_(0, index, src.reshape((1, ) + arr.shape[1:]))
            return arr
        if not arr.flags.writeable:
            arr = arr.copy()
        arr[idx] = row
        return arr

    def admit(self, req, values):
        """Write one prefilled request into a free slot: ``values`` are the
        per-request prefill fetches ([1, ...] each, state + context order),
        zero-padded up to the slab's trailing shape.  Returns the slot
        index (the caller checked free_slots() first)."""
        with self._lock:
            if not self._free:
                raise RuntimeError('SlotStateCache: no free slot')
            idx = self._free.pop(0)
            self._requests[idx] = req
        for name, val in zip(self.spec.slot_feeds, values):
            row = np.asarray(val)
            if row.ndim >= 1 and row.shape[0] == 1:
                row = row[0]
            want = self.spec.slot_shapes[name]
            if row.shape != want:
                if len(row.shape) != len(want) or \
                        any(r > w for r, w in zip(row.shape, want)):
                    raise ValueError(
                        'decode admission: prefill value for %r has '
                        'shape %s, slot slab is %s — prefill fetches '
                        'must match the step program\'s declared state '
                        'shape (or be narrower on trailing axes)'
                        % (name, row.shape, want))
                padded = np.zeros(want, row.dtype)
                padded[tuple(slice(0, d) for d in row.shape)] = row
                row = padded
            self._slabs[name] = self._write_row(
                self._slabs[name], idx,
                row.astype(self.spec.slot_dtypes[name], copy=False))
        self._token = self._write_row(
            self._token, idx,
            np.asarray([self.spec.start_id],
                       self.spec.slot_dtypes[self.spec.token_feed]))
        self._alive = self._write_row(self._alive, idx, True)
        self._remaining = self._write_row(
            self._remaining, idx, np.int32(min(req.max_len,
                                               self.spec.max_len)))
        req.slot = idx
        return idx

    def admit_prefilling(self, req):
        """Admit one request into a free slot in the PREFILLING phase:
        every slab row zeroes (both model families' position 0), the carry
        leaves go inert (token=end_id, alive=False, remaining=0) and the
        cursor starts at 0.  The chunk dispatches advance the slabs; the
        finishing chunk flips the slot to decoding on the device."""
        with self._lock:
            if not self._free:
                raise RuntimeError('SlotStateCache: no free slot')
            idx = self._free.pop(0)
            self._requests[idx] = req
            self._prefill[idx] = 0
        for name in self.spec.slot_feeds:
            self._slabs[name] = self._write_row(
                self._slabs[name], idx,
                np.zeros(self.spec.slot_shapes[name],
                         self.spec.slot_dtypes[name]))
        self._deactivate_row(idx)
        req.slot = idx
        req.prefilling = True
        return idx

    def prefilling_items(self):
        """[(slot, request, cursor)] for every slot mid-prefill."""
        with self._lock:
            return [(idx, self._requests[idx], cur)
                    for idx, cur in sorted(self._prefill.items())]

    def advance_prefill(self, idx, n):
        """Move one prefilling slot's cursor by ``n`` consumed prompt
        tokens (the host mirror of the dispatched chunk)."""
        with self._lock:
            self._prefill[idx] += int(n)
            return self._prefill[idx]

    def finish_prefill(self, idx):
        """The slot's finishing chunk dispatched: it leaves the prefilling
        phase (the chunk advance already flipped its carry)."""
        with self._lock:
            self._prefill.pop(idx, None)
        req = self.request_at(idx)
        if req is not None:
            req.prefilling = False

    def release(self, idx):
        with self._lock:
            req = self._requests[idx]
            self._requests[idx] = None
            self._free.append(idx)
            self._prefill.pop(idx, None)
        if req is not None:
            req.slot = None
        return req

    def _deactivate_row(self, idx):
        self._token = self._write_row(
            self._token, idx,
            np.asarray([self.spec.end_id],
                       self.spec.slot_dtypes[self.spec.token_feed]))
        self._alive = self._write_row(self._alive, idx, False)
        self._remaining = self._write_row(self._remaining, idx,
                                          np.int32(0))

    def deactivate(self, idx):
        """Mask one slot out of the loop NOW (a mid-generation shed): alive
        False, remaining 0, token end_id.  Worker-thread only."""
        self._deactivate_row(idx)

    def reset(self):
        """Every slab and carry leaf back to fresh host arrays and every
        slot free (the chained lane's recovery after a failed dispatch or
        harvest)."""
        self._init_state()

    def request_at(self, idx):
        with self._lock:
            return self._requests[idx]

    def active_requests(self):
        with self._lock:
            return [r for r in self._requests if r is not None]

    # ---- accounting / observability ------------------------------------

    def _leaves(self):
        return list(self._slabs.values()) + [
            self._token, self._alive, self._remaining]

    def nbytes(self):
        """Bytes of every slab and carry leaf, on the host or the card."""
        return sum(_nbytes(arr) for arr in self._leaves())

    def to_host(self):
        """Demote every leaf held as a tensor (on the engine's place: the
        card, or the CPU under ``CPUPlace()``) to a host array, bit for bit
        (decode resumes exactly after the next dispatch stages it back).
        Returns the bytes moved."""
        moved = 0

        def host(arr):
            nonlocal moved
            if isinstance(arr, torch.Tensor):
                moved += _nbytes(arr)
                return arr.detach().cpu().numpy()
            return arr

        self._slabs = {n: host(a) for n, a in self._slabs.items()}
        self._token = host(self._token)
        self._alive = host(self._alive)
        self._remaining = host(self._remaining)
        return moved

    def snapshot(self):
        """The flight recorder's slot-map view: who holds each slot (trace
        ids), occupancy, and the cache's byte size."""
        with self._lock:
            return {
                'slots': self.slots,
                'active': self.slots - len(self._free),
                'free': len(self._free),
                'prefilling': len(self._prefill),
                'bytes': self.nbytes(),
                'slot_trace_ids': [
                    (r.trace_id if r is not None else None)
                    for r in self._requests
                ],
            }

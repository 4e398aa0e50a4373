"""Runtime core of the PyTorch port: places, dtype enums, Scope, LoDTensor.

Counterpart of ``paddle_tpu/fluid/core.py``.  A ``Place`` carries an explicit
``torch.device``; scope values are torch tensors.

- ``CUDAPlace(i)`` is a real ``torch.device('cuda', i)``.  In the JAX package
  ``CUDAPlace`` is an alias of ``TPUPlace``; here there is no TPU.
- ``CPUPlace()`` is ``torch.device('cpu')``: the place tests pass to run the
  plain versions of the kernels.
- ``LoDTensor`` wraps one torch tensor and, for a sequence feed, its
  level-of-detail offsets (the reference's recursive sequence lengths); the
  executor lowers a one-level LoD feed to a padded tensor plus lengths.
- ``SelectedRows`` is a row subset {rows, value, height}: the host-side form
  of a sparse gradient, as the executor hands a fetched one back.
- ``LoDTensorArray`` is a list of LoDTensors: the host-side form of a
  tensor array (a ``LOD_TENSOR_ARRAY`` var), as the executor hands a
  fetched one back.
- ``PaddedSequence`` is a LoD feed already lowered: padded [B, T, ...]
  data and per-row lengths, which the executor feeds as the data and its
  ``@SEQLEN`` side-band.
"""

import numpy as np
import torch

__all__ = ['CPUPlace', 'CUDAPlace', 'CUDAPinnedPlace', 'Place', 'VarDesc',
           'LoDTensor', 'LoDTensorArray', 'SelectedRows', 'PaddedSequence',
           'Scope', 'global_scope', 'EOFException', 'is_compiled_with_cuda',
           'is_compiled_with_tpu']


class EOFException(Exception):
    """Raised by ``Executor.run`` (and the reader-fed multi paths) when a
    program's reader is exhausted, as the reference's reader ops throw
    it."""


def is_compiled_with_cuda():
    """Whether the torch this port runs on was built with CUDA."""
    return torch.backends.cuda.is_built()


def is_compiled_with_tpu():
    """False: the port has no TPU device (the JAX package's TPUPlace has no
    counterpart here)."""
    return False


class Place(object):
    """Base class of device placements; ``device`` is the torch.device."""

    def __eq__(self, other):
        return type(self) is type(other) and self.device == other.device

    def __hash__(self):
        return hash((type(self).__name__, str(self.device)))


class CPUPlace(Place):
    device = torch.device('cpu')

    def __repr__(self):
        return 'CPUPlace'


class CUDAPlace(Place):
    """CUDA card ``device_id``.  Constructing one needs no card; running on
    one does (``Executor`` raises when the card is absent)."""

    def __init__(self, device_id=0):
        self.device_id = int(device_id)
        self.device = torch.device('cuda', self.device_id)

    def __repr__(self):
        return 'CUDAPlace(%d)' % self.device_id


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory: a host place, as in the reference.  The
    port pins what it stages for the card itself (the feed pipeline and
    ``double_buffer``), so a value placed here lives on the CPU."""

    def __repr__(self):
        return 'CUDAPinnedPlace'


# ----------------------------------------------------------------------------
# Dtype enum (framework.proto VarType, as in the JAX package)
# ----------------------------------------------------------------------------
class VarDesc(object):
    class VarType(object):
        # data types
        BOOL = 0
        INT16 = 1
        INT32 = 2
        INT64 = 3
        FP16 = 4
        FP32 = 5
        FP64 = 6
        UINT8 = 20
        INT8 = 21
        BF16 = 22
        # var kinds
        LOD_TENSOR = 7
        SELECTED_ROWS = 8
        FEED_MINIBATCH = 9
        FETCH_LIST = 10
        STEP_SCOPES = 11
        LOD_RANK_TABLE = 12
        LOD_TENSOR_ARRAY = 13
        PLACE_LIST = 14
        READER = 15
        CHANNEL = 16
        RAW = 17
        TUPLE = 18


_DTYPE_TO_NP = {
    VarDesc.VarType.BOOL: np.bool_,
    VarDesc.VarType.INT16: np.int16,
    VarDesc.VarType.INT32: np.int32,
    VarDesc.VarType.INT64: np.int64,
    VarDesc.VarType.FP16: np.float16,
    VarDesc.VarType.FP32: np.float32,
    VarDesc.VarType.FP64: np.float64,
    VarDesc.VarType.UINT8: np.uint8,
    VarDesc.VarType.INT8: np.int8,
}
_NP_TO_DTYPE = {np.dtype(v): k for k, v in _DTYPE_TO_NP.items()}

_DTYPE_TO_TORCH = {
    VarDesc.VarType.BOOL: torch.bool,
    VarDesc.VarType.INT16: torch.int16,
    VarDesc.VarType.INT32: torch.int32,
    VarDesc.VarType.INT64: torch.int64,
    VarDesc.VarType.FP16: torch.float16,
    VarDesc.VarType.FP32: torch.float32,
    VarDesc.VarType.FP64: torch.float64,
    VarDesc.VarType.UINT8: torch.uint8,
    VarDesc.VarType.INT8: torch.int8,
    VarDesc.VarType.BF16: torch.bfloat16,
}


_TORCH_TO_DTYPE = {v: k for k, v in _DTYPE_TO_TORCH.items()}


def convert_np_dtype_to_dtype_(np_dtype):
    """numpy dtype, torch dtype or string -> VarType enum.  bfloat16 comes
    as ``torch.bfloat16`` or the string ``'bfloat16'``: numpy has none."""
    if isinstance(np_dtype, int):
        return np_dtype
    if isinstance(np_dtype, torch.dtype):
        return _TORCH_TO_DTYPE[np_dtype]
    if np_dtype in ('bfloat16', 'bf16'):
        return VarDesc.VarType.BF16
    dtype = np.dtype(np_dtype)
    if dtype in _NP_TO_DTYPE:
        return _NP_TO_DTYPE[dtype]
    raise ValueError('unsupported numpy dtype %s' % np_dtype)


def convert_dtype_to_np(dtype):
    """VarType enum (or string/np dtype) -> numpy dtype.  numpy has no
    bfloat16: a BF16 var has no numpy dtype here, and code that meets one
    asks for its torch dtype (``convert_dtype_to_torch``,
    ``Variable.torch_dtype``) instead."""
    if dtype == VarDesc.VarType.BF16 or dtype in ('bfloat16', 'bf16') or \
            dtype == torch.bfloat16:
        raise ValueError('bfloat16 has no numpy dtype in the PyTorch port')
    if isinstance(dtype, int):
        return np.dtype(_DTYPE_TO_NP[dtype])
    return np.dtype(dtype)


def convert_dtype_to_torch(dtype):
    """VarType enum (or string/np dtype) -> torch dtype."""
    return _DTYPE_TO_TORCH[convert_np_dtype_to_dtype_(dtype)]


class PaddedSequence(object):
    """A LoD feed already lowered to padded [B, T, ...] ``data`` plus
    per-row ``lengths`` (counterpart of the JAX package's
    ``core.PaddedSequence``, which its double-buffer reader stages ahead
    of the compute).  ``rows`` is the OUTER level of a nested (2-level
    LoD) batch, or None; the port does not feed nested LoD yet."""

    __slots__ = ('data', 'lengths', 'rows')

    def __init__(self, data, lengths, rows=None):
        self.data = data
        self.lengths = lengths
        self.rows = rows


# ----------------------------------------------------------------------------
# LoDTensor
# ----------------------------------------------------------------------------
class LoDTensor(object):
    """A tensor value as the fluid API hands it around: one torch tensor and
    optional level-of-detail offsets.

    ``lod`` is a list of offset vectors, one per nesting level, each starting
    at 0 and non-decreasing; the last level's final offset equals dim 0 of
    the data (the reference's recursive-sequence-length semantics)."""

    def __init__(self, tensor=None):
        self._tensor = None if tensor is None else torch.as_tensor(tensor)
        self._lod = []

    def set(self, array, place=None):
        device = place.device if place is not None else torch.device('cpu')
        self._tensor = torch.as_tensor(np.asarray(array)).to(device)

    def tensor(self):
        return self._tensor

    def set_lod(self, lod):
        self._lod = [list(l) for l in lod]

    def lod(self):
        return [list(l) for l in self._lod]

    def set_recursive_sequence_lengths(self, lengths):
        self._lod = []
        for level in lengths:
            offsets = [0]
            for n in level:
                offsets.append(offsets[-1] + n)
            self._lod.append(offsets)

    def recursive_sequence_lengths(self):
        return [[l[i + 1] - l[i] for i in range(len(l) - 1)]
                for l in self._lod]

    def has_valid_recursive_sequence_lengths(self):
        for level in self._lod:
            if not level or level[0] != 0:
                return False
            if any(level[i] > level[i + 1] for i in range(len(level) - 1)):
                return False
        if self._tensor is not None and self._lod:
            return self._lod[-1][-1] == self._tensor.shape[0]
        return True

    def shape(self):
        return list(self._tensor.shape) if self._tensor is not None else []

    def numpy(self):
        return self._tensor.detach().cpu().numpy()

    def __array__(self, dtype=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return 'LoDTensor(shape=%s, lod=%s)' % (self.shape(), self._lod)


class LoDTensorArray(list):
    """An ordered list of LoDTensors (the reference's LoDTensorArray:
    ``append`` and indexing), made and read by the tensor-array ops."""

    def append(self, tensor):
        if not isinstance(tensor, LoDTensor):
            tensor = LoDTensor(np.asarray(tensor))
        list.append(self, tensor)


# ----------------------------------------------------------------------------
# SelectedRows
# ----------------------------------------------------------------------------
class SelectedRows(object):
    """Row-subset tensor {rows, value, height}, the host-side mirror of a
    sparse gradient (the reference's rows/set_rows/height/set_height/
    get_tensor surface).  Rows may repeat: ``to_dense`` sums them."""

    def __init__(self, rows=None, height=0):
        self._rows = list(rows) if rows is not None else []
        self._height = int(height)
        self._tensor = LoDTensor()

    def rows(self):
        return self._rows

    def set_rows(self, rows):
        self._rows = list(rows)

    def height(self):
        return self._height

    def set_height(self, height):
        self._height = int(height)

    def get_tensor(self):
        return self._tensor

    def to_dense(self):
        vals = self._tensor.numpy()
        out = np.zeros((self._height, ) + vals.shape[1:], vals.dtype)
        np.add.at(out, np.asarray(self._rows, np.int64), vals)
        return out

    def __repr__(self):
        return 'SelectedRows(n=%d, height=%d)' % (len(self._rows),
                                                  self._height)


# ----------------------------------------------------------------------------
# Scope
# ----------------------------------------------------------------------------
class _ScopeVariable(object):
    """Runtime variable slot; the value is a torch tensor or a LoDTensor."""

    __slots__ = ['_value']

    def __init__(self):
        self._value = None

    def get_tensor(self):
        if self._value is None:
            self._value = LoDTensor()
        return self._value

    def set_value(self, value):
        self._value = value

    def value(self):
        return self._value


class Scope(object):
    """Hierarchical name->Variable map with parent-chain lookup."""

    def __init__(self, parent=None):
        self._vars = {}
        self._parent = parent

    def var(self, name):
        v = self.find_var(name)
        if v is None:
            v = _ScopeVariable()
            self._vars[name] = v
        return v

    def find_var(self, name):
        if name in self._vars:
            return self._vars[name]
        if self._parent is not None:
            return self._parent.find_var(name)
        return None

    def local_var_names(self):
        return list(self._vars.keys())


_global_scope = Scope()


def global_scope():
    return _global_scope

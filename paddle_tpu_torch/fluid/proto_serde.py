"""framework.proto-compatible serialization — the public contract
(counterpart of ``paddle_tpu/fluid/proto_serde.py``, the same bytes).

The reference's model artifacts are protobuf ``ProgramDesc`` bytes
(framework/framework.proto:183; inference loads ``__model__`` at
inference/io.cc:117) and version-0 LoDTensor streams
(framework/lod_tensor.cc:251 SerializeToStream, tensor_util.cc:244
TensorToStream).  This module speaks both formats with a hand-written
proto2 wire codec — no generated code, no protoc build step — so
programs and parameters saved here load under the reference contract
and vice versa.

Wire facts used (proto2):
  tag = (field_number << 3) | wire_type; wire types: 0 varint,
  2 length-delimited, 5 fixed32 (float).  Repeated scalar fields are
  emitted unpacked (one tag per element), proto2's default.  Signed
  int32/int64 values are encoded as 64-bit two's-complement varints.

Field numbers (framework.proto):
  ProgramDesc.blocks=1
  BlockDesc: idx=1 parent_idx=2 vars=3 ops=4 forward_block_idx=5
  VarDesc: name=1 type=2 persistable=3
  VarType: type=1 selected_rows=2 lod_tensor=3 tensor_array=4
           reader=5 channel=6
  VarType.TensorDesc: data_type=1 dims=2
  VarType.LoDTensorDesc: tensor=1 lod_level=2
  VarType.ChannelDesc: data_type=1 capacity=2
  OpDesc: inputs=1 outputs=2 type=3 attrs=4 is_target=5
  OpDesc.Var: parameter=1 arguments=2
  OpDesc.Attr: name=1 type=2 i=3 f=4 s=5 ints=6 floats=7 strings=8
               b=10 bools=11 block_idx=12 l=13 blocks_idx=14
  AttrType enum: INT=0 FLOAT=1 STRING=2 INTS=3 FLOATS=4 STRINGS=5
                 BOOLEAN=6 BOOLEANS=7 BLOCK=8 LONG=9 BLOCKS=10

Tensor streams carry torch tensors here: ``serialize_lod_tensor`` takes a
tensor (or a numpy array) and ``read_lod_tensor`` gives a CPU tensor.  A
bfloat16 tensor, which numpy cannot hold, travels as its raw 16-bit words
(``tensor.view(torch.int16)``) under the BF16 enum, as the JAX package
writes an ``ml_dtypes.bfloat16`` array.
"""

import struct

import numpy as np
import torch

from . import core

__all__ = [
    'serialize_program', 'deserialize_program', 'serialize_lod_tensor',
    'deserialize_lod_tensor', 'read_lod_tensor'
]

_INT32_MIN, _INT32_MAX = -2**31, 2**31 - 1


# ----------------------------------------------------------------------------
# proto2 wire primitives
# ----------------------------------------------------------------------------
def _varint(value):
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _tag(field, wire):
    return _varint((field << 3) | wire)


def _field_varint(field, value):
    return _tag(field, 0) + _varint(int(value))


def _field_bytes(field, data):
    return _tag(field, 2) + _varint(len(data)) + data


def _field_str(field, s):
    return _field_bytes(field, s.encode('utf-8'))


def _field_float(field, value):
    return _tag(field, 5) + struct.pack('<f', float(value))


class _Reader(object):
    def __init__(self, data):
        self.data = data
        self.pos = 0

    def eof(self):
        return self.pos >= len(self.data)

    def varint(self):
        result = 0
        shift = 0
        while True:
            byte = self.data[self.pos]
            self.pos += 1
            result |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return result
            shift += 7

    def signed(self):
        v = self.varint()
        return v - (1 << 64) if v >= (1 << 63) else v

    def ld(self):
        n = self.varint()
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def fixed32(self):
        v = struct.unpack_from('<f', self.data, self.pos)[0]
        self.pos += 4
        return v

    def skip(self, wire):
        if wire == 0:
            self.varint()
        elif wire == 1:
            self.pos += 8
        elif wire == 2:
            self.ld()
        elif wire == 5:
            self.pos += 4
        else:
            raise ValueError('unsupported wire type %d' % wire)

    def fields(self):
        """Yield (field_number, wire_type, value) triples; value is the
        raw varint / bytes / float depending on wire type."""
        while not self.eof():
            key = self.varint()
            field, wire = key >> 3, key & 7
            if wire == 0:
                yield field, wire, self.signed()
            elif wire == 2:
                yield field, wire, self.ld()
            elif wire == 5:
                yield field, wire, self.fixed32()
            else:
                self.skip(wire)


# ----------------------------------------------------------------------------
# VarDesc / VarType
# ----------------------------------------------------------------------------
_VT = core.VarDesc.VarType


def _tensor_desc(dtype_enum, dims):
    out = _field_varint(1, dtype_enum)
    for d in dims:
        out += _field_varint(2, int(d))
    return out


def _lod_tensor_desc(dtype_enum, dims, lod_level):
    out = _field_bytes(1, _tensor_desc(dtype_enum, dims))
    if lod_level:
        out += _field_varint(2, int(lod_level))
    return out


def _var_type_bytes(v):
    out = _field_varint(1, v.type)
    dims = [d if d is not None else -1 for d in (v.shape or ())]
    if v.type == _VT.LOD_TENSOR:
        out += _field_bytes(
            3, _lod_tensor_desc(v.dtype, dims, v.lod_level))
    elif v.type == _VT.SELECTED_ROWS:
        out += _field_bytes(2, _tensor_desc(v.dtype, dims))
    elif v.type == _VT.LOD_TENSOR_ARRAY:
        out += _field_bytes(
            4, _lod_tensor_desc(v.dtype, dims, v.lod_level))
    elif v.type == _VT.READER:
        out += _field_bytes(5, b'')
    elif v.type == _VT.CHANNEL:
        cap = getattr(v, 'capacity', None) or 0
        out += _field_bytes(
            6, _field_varint(1, v.dtype) + _field_varint(2, cap))
    return out


def _var_desc_bytes(v):
    out = _field_str(1, v.name)
    out += _field_bytes(2, _var_type_bytes(v))
    if v.persistable:
        out += _field_varint(3, 1)
    return out


def _parse_tensor_desc(data):
    dtype, dims = _VT.FP32, []
    for field, wire, val in _Reader(data).fields():
        if field == 1:
            dtype = val
        elif field == 2:
            dims.append(val)
    return dtype, dims


def _parse_lod_tensor_desc(data):
    dtype, dims, lod_level = _VT.FP32, [], 0
    for field, wire, val in _Reader(data).fields():
        if field == 1:
            dtype, dims = _parse_tensor_desc(val)
        elif field == 2:
            lod_level = val
    return dtype, dims, lod_level


def _parse_var_type(data):
    kind, dtype, dims, lod_level, capacity = _VT.LOD_TENSOR, _VT.FP32, [], \
        0, None
    for field, wire, val in _Reader(data).fields():
        if field == 1:
            kind = val
        elif field in (2, ):  # selected_rows TensorDesc
            dtype, dims = _parse_tensor_desc(val)
        elif field in (3, 4):  # lod_tensor / tensor_array
            dtype, dims, lod_level = _parse_lod_tensor_desc(val)
        elif field == 6:  # channel
            for f2, w2, v2 in _Reader(val).fields():
                if f2 == 1:
                    dtype = v2
                elif f2 == 2:
                    capacity = v2
    return kind, dtype, dims, lod_level, capacity


def _parse_var_desc(data):
    name, vtype, persistable = '', b'', False
    for field, wire, val in _Reader(data).fields():
        if field == 1:
            name = val.decode('utf-8')
        elif field == 2:
            vtype = val
        elif field == 3:
            persistable = bool(val)
    kind, dtype, dims, lod_level, capacity = _parse_var_type(vtype)
    return dict(name=name, type=kind, dtype=dtype, shape=dims,
                lod_level=lod_level, capacity=capacity,
                persistable=persistable)


# ----------------------------------------------------------------------------
# OpDesc attrs
# ----------------------------------------------------------------------------
def _is_int(x):
    return isinstance(x, (int, np.integer)) and not isinstance(
        x, (bool, np.bool_))


def _attr_bytes(name, value):
    from .framework import Block
    out = _field_str(1, name)
    if isinstance(value, np.ndarray):
        value = value.tolist()
    if isinstance(value, Block):
        out += _field_varint(2, 8)  # BLOCK
        out += _field_varint(12, value.idx)
    elif isinstance(value, (bool, np.bool_)):
        out += _field_varint(2, 6)  # BOOLEAN
        out += _field_varint(10, 1 if value else 0)
    elif _is_int(value):
        if _INT32_MIN <= int(value) <= _INT32_MAX:
            out += _field_varint(2, 0)  # INT
            out += _field_varint(3, int(value))
        else:
            out += _field_varint(2, 9)  # LONG
            out += _field_varint(13, int(value))
    elif isinstance(value, (float, np.floating)):
        out += _field_varint(2, 1)  # FLOAT
        out += _field_float(4, value)
    elif isinstance(value, str):
        out += _field_varint(2, 2)  # STRING
        out += _field_str(5, value)
    elif isinstance(value, (list, tuple)):
        items = list(value)
        if items and isinstance(items[0], Block):
            out += _field_varint(2, 10)  # BLOCKS
            for b in items:
                out += _field_varint(14, b.idx)
        elif items and isinstance(items[0], (bool, np.bool_)):
            out += _field_varint(2, 7)  # BOOLEANS
            for b in items:
                out += _field_varint(11, 1 if b else 0)
        elif items and isinstance(items[0], (float, np.floating)):
            out += _field_varint(2, 4)  # FLOATS
            for f in items:
                out += _field_float(7, f)
        elif items and isinstance(items[0], str):
            out += _field_varint(2, 5)  # STRINGS
            for s in items:
                out += _field_str(8, s)
        else:
            # ints — and the EMPTY-list fallback.  The wire attr type is
            # inferred from the first element because the in-memory attr
            # is a plain Python list; an empty FLOATS/STRINGS/BOOLEANS
            # attr therefore degrades to INTS-with-no-elements on the
            # wire.  Our own loader treats any empty list identically;
            # a strict foreign OpDesc type-checker could reject such a
            # program (documented delta, ADVICE r2 #1).
            out += _field_varint(2, 3)
            for i in items:
                out += _field_varint(6, int(i))
    else:
        raise TypeError('attr %r: unserializable value %r (%s)' %
                        (name, value, type(value).__name__))
    return out


def _parse_attr(data, program):
    name = None
    atype = 0
    scalars = {}
    ints, floats, strings, bools, blocks_idx = [], [], [], [], []
    for field, wire, val in _Reader(data).fields():
        if field == 1:
            name = val.decode('utf-8')
        elif field == 2:
            atype = val
        elif field == 3:
            scalars['i'] = val
        elif field == 4:
            scalars['f'] = val
        elif field == 5:
            scalars['s'] = val.decode('utf-8')
        elif field == 6:
            ints.append(val)
        elif field == 7:
            floats.append(val)
        elif field == 8:
            strings.append(val.decode('utf-8'))
        elif field == 10:
            scalars['b'] = bool(val)
        elif field == 11:
            bools.append(bool(val))
        elif field == 12:
            scalars['block_idx'] = val
        elif field == 13:
            scalars['l'] = val
        elif field == 14:
            blocks_idx.append(val)
    value = {
        0: lambda: scalars.get('i', 0),
        1: lambda: scalars.get('f', 0.0),
        2: lambda: scalars.get('s', ''),
        3: lambda: ints,
        4: lambda: floats,
        5: lambda: strings,
        6: lambda: scalars.get('b', False),
        7: lambda: bools,
        8: lambda: program.block(scalars['block_idx']),
        9: lambda: scalars.get('l', 0),
        10: lambda: [program.block(i) for i in blocks_idx],
    }[atype]()
    return name, value


def _op_var_bytes(field, parameter, arguments):
    body = _field_str(1, parameter)
    for a in arguments:
        body += _field_str(2, a)
    return _field_bytes(field, body)


def _op_desc_bytes(op):
    out = b''
    for param, args in op.inputs.items():
        out += _op_var_bytes(1, param, args)
    for param, args in op.outputs.items():
        out += _op_var_bytes(2, param, args)
    out += _field_str(3, op.type)
    for name, value in op.attrs.items():
        if name in _MUTABLE_RUNTIME_ATTRS:
            continue
        out += _field_bytes(4, _attr_bytes(name, value))
    return out


# per-run mutable counters, not program structure
_MUTABLE_RUNTIME_ATTRS = frozenset(['__print_count__'])


def _parse_op_var(data):
    param, args = '', []
    for field, wire, val in _Reader(data).fields():
        if field == 1:
            param = val.decode('utf-8')
        elif field == 2:
            args.append(val.decode('utf-8'))
    return param, args


def _parse_op_desc(data, program):
    op_type, inputs, outputs, raw_attrs = '', {}, {}, []
    for field, wire, val in _Reader(data).fields():
        if field == 1:
            p, a = _parse_op_var(val)
            inputs[p] = a
        elif field == 2:
            p, a = _parse_op_var(val)
            outputs[p] = a
        elif field == 3:
            op_type = val.decode('utf-8')
        elif field == 4:
            raw_attrs.append(val)
    attrs = {}
    for raw in raw_attrs:
        name, value = _parse_attr(raw, program)
        attrs[name] = value
    return op_type, inputs, outputs, attrs


# ----------------------------------------------------------------------------
# ProgramDesc
# ----------------------------------------------------------------------------
def serialize_program(program):
    """Program -> framework.proto ProgramDesc bytes."""
    out = b''
    for blk in program.blocks:
        body = _field_varint(1, blk.idx)
        # root block parent is -1 in the reference's emitted bytes
        # (signed 64-bit varint); sub-blocks carry their real parent
        parent = (blk.parent_idx if blk.parent_idx is not None
                  and blk.parent_idx >= 0 else -1)
        body += _field_varint(2, parent)
        for v in blk.vars.values():
            body += _field_bytes(3, _var_desc_bytes(v))
        for op in blk.ops:
            body += _field_bytes(4, _op_desc_bytes(op))
        out += _field_bytes(1, body)
    return out


def deserialize_program(data):
    """framework.proto ProgramDesc bytes -> Program."""
    from .framework import Program, Block, Variable, Operator
    raw_blocks = [val for field, wire, val in _Reader(data).fields()
                  if field == 1]
    # first pass: block skeletons, so sub_block attrs can resolve
    parsed = []
    for raw in raw_blocks:
        idx, parent, raw_vars, raw_ops = 0, 0, [], []
        for field, wire, val in _Reader(raw).fields():
            if field == 1:
                idx = val
            elif field == 2:
                parent = val
            elif field == 3:
                raw_vars.append(val)
            elif field == 4:
                raw_ops.append(val)
        parsed.append((idx, parent, raw_vars, raw_ops))
    program = Program()
    while len(program.blocks) < len(parsed):
        i = len(program.blocks)
        program.blocks.append(Block(program, i, parsed[i][1]))
    program.current_block_idx = 0
    for (idx, parent, raw_vars, raw_ops), blk in zip(parsed,
                                                     program.blocks):
        blk.parent_idx = parent if idx != 0 else -1
        for raw in raw_vars:
            kw = _parse_var_desc(raw)
            capacity = kw.pop('capacity', None)
            v = Variable(blk, **kw)
            if capacity:
                v.capacity = capacity
            blk.vars[v.name] = v
        for raw in raw_ops:
            op_type, inputs, outputs, attrs = _parse_op_desc(raw, program)
            blk.ops.append(
                Operator(blk, op_type, inputs=inputs, outputs=outputs,
                         attrs=attrs))
    program._bump_version()
    return program


# ----------------------------------------------------------------------------
# LoDTensor / Tensor streams (lod_tensor.cc:251, tensor_util.cc:244)
# ----------------------------------------------------------------------------
def _tensor_bytes(t):
    """(VarType enum, shape, raw little-endian bytes) of a tensor or array."""
    if not isinstance(t, torch.Tensor):
        a = np.asarray(t)  # ascontiguousarray makes a 0-d array 1-d
        t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
    t = t.detach().cpu().contiguous()
    enum = core.convert_np_dtype_to_dtype_(t.dtype)
    words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return enum, tuple(t.shape), words.numpy().tobytes()


def serialize_lod_tensor(arr, lod=()):
    """A tensor or ndarray (+ offset-based LoD levels) -> version-0 stream
    bytes."""
    enum, shape, data = _tensor_bytes(arr)
    out = [struct.pack('<I', 0)]               # LoDTensor version
    out.append(struct.pack('<Q', len(lod)))    # lod level count
    for level in lod:
        lv = np.asarray(level, np.uint64)
        out.append(struct.pack('<Q', lv.nbytes))
        out.append(lv.tobytes())
    out.append(struct.pack('<I', 0))           # Tensor version
    desc = _tensor_desc(enum, shape)
    out.append(struct.pack('<i', len(desc)))
    out.append(desc)
    out.append(data)
    return b''.join(out)


def read_lod_tensor(f):
    """Read one LoDTensor stream from a file object -> (CPU tensor, lod)."""
    version, = struct.unpack('<I', f.read(4))
    if version != 0:
        raise ValueError('unsupported LoDTensor version %d' % version)
    n_levels, = struct.unpack('<Q', f.read(8))
    lod = []
    for _ in range(n_levels):
        nbytes, = struct.unpack('<Q', f.read(8))
        lod.append(np.frombuffer(f.read(nbytes), np.uint64).tolist())
    t_version, = struct.unpack('<I', f.read(4))
    if t_version != 0:
        raise ValueError('unsupported Tensor version %d' % t_version)
    desc_len, = struct.unpack('<i', f.read(4))
    dtype_enum, dims = _parse_tensor_desc(f.read(desc_len))
    bf16 = dtype_enum == _VT.BF16
    np_dtype = np.dtype(np.int16 if bf16 else
                        core.convert_dtype_to_np(dtype_enum))
    count = int(np.prod(dims, dtype=np.int64)) if dims else 1
    arr = np.frombuffer(f.read(count * np_dtype.itemsize), np_dtype)
    t = torch.from_numpy(arr.reshape(dims).copy())
    return (t.view(torch.bfloat16) if bf16 else t), lod


def deserialize_lod_tensor(data):
    import io as _io
    return read_lod_tensor(_io.BytesIO(data))

"""The structural-JSON program format of the JAX package's earlier model
artifacts (counterpart of ``paddle_tpu/fluid/program_serde.py``).

Models are saved as framework.proto bytes (``proto_serde``); this format
is read by ``Program.parse_from_string`` and ``load_inference_model``'s
legacy JSON wrapper branch, and written only to make such an artifact.
Sub-block references in op attrs are ``{'__block__': idx}`` markers.
"""

import json

import numpy as np

from . import core


def _var_to_dict(v):
    from .framework import Parameter
    return {
        'name': v.name,
        'type': v.type,
        'shape': list(v.shape),
        'dtype': v.dtype,
        'lod_level': v.lod_level,
        'persistable': v.persistable,
        'stop_gradient': v.stop_gradient,
        'is_data': v.is_data,
        'is_parameter': isinstance(v, Parameter),
        'trainable': getattr(v, 'trainable', False),
    }


def _attr_to_serializable(val):
    from .framework import Block
    if isinstance(val, Block):
        return {'__block__': val.idx}
    if isinstance(val, np.ndarray):
        return {'__ndarray__': val.tolist(), '__dtype__': str(val.dtype)}
    if isinstance(val, np.integer):
        return int(val)
    if isinstance(val, np.floating):
        return float(val)
    if isinstance(val, np.bool_):
        return bool(val)
    if isinstance(val, (list, tuple)):
        return [_attr_to_serializable(v) for v in val]
    return val


def _attr_from_serializable(val, program):
    if isinstance(val, dict) and '__block__' in val:
        return program.block(val['__block__'])
    if isinstance(val, dict) and '__ndarray__' in val:
        return np.asarray(val['__ndarray__'], dtype=val['__dtype__'])
    return val


def program_to_dict(program):
    blocks = []
    for blk in program.blocks:
        blocks.append({
            'idx': blk.idx,
            'parent_idx': blk.parent_idx,
            'vars': [_var_to_dict(v) for v in blk.vars.values()],
            'ops': [{
                'type': op.type,
                'inputs': {k: list(v) for k, v in op.inputs.items()},
                'outputs': {k: list(v) for k, v in op.outputs.items()},
                'attrs': {k: _attr_to_serializable(v)
                          for k, v in op.attrs.items()},
            } for op in blk.ops],
        })
    return {'blocks': blocks, 'random_seed': program.random_seed}


def dict_to_program(data):
    from .framework import Program, Block, Variable, Parameter, Operator
    program = Program()
    # make the right number of blocks first (for sub-block attr resolution)
    while len(program.blocks) < len(data['blocks']):
        program.blocks.append(
            Block(program, len(program.blocks),
                  data['blocks'][len(program.blocks)]['parent_idx']))
    program.current_block_idx = 0
    program.random_seed = data.get('random_seed', 0)
    for bdata, blk in zip(data['blocks'], program.blocks):
        blk.parent_idx = bdata['parent_idx']
        for vd in bdata['vars']:
            kwargs = dict(
                type=vd['type'],
                name=vd['name'],
                shape=vd['shape'],
                dtype=vd['dtype'],
                lod_level=vd['lod_level'],
                persistable=vd['persistable'],
                stop_gradient=vd['stop_gradient'],
                is_data=vd['is_data'])
            if vd.get('is_parameter'):
                p = Parameter(blk, shape=vd['shape'], dtype=vd['dtype'],
                              name=vd['name'],
                              persistable=vd['persistable'])
                p.trainable = vd.get('trainable', True)
                p.stop_gradient = vd['stop_gradient']
                blk.vars[p.name] = p
            else:
                v = Variable(blk, **kwargs)
                blk.vars[v.name] = v
        for od in bdata['ops']:
            op = Operator(
                blk,
                od['type'],
                inputs=od['inputs'],
                outputs=od['outputs'],
                attrs={
                    k: _attr_from_serializable(v, program)
                    for k, v in od['attrs'].items()
                })
            blk.ops.append(op)
    program._bump_version()
    return program


def serialize_program(program):
    # JSON, not pickle: loading a model from disk must never execute code
    return json.dumps(program_to_dict(program)).encode('utf-8')


def deserialize_program(data):
    if isinstance(data, bytes):
        data = data.decode('utf-8')
    return dict_to_program(json.loads(data))

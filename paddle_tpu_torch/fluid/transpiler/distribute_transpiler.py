"""DistributeTranspiler (counterpart of
``paddle_tpu/fluid/transpiler/distribute_transpiler.py``; reference:
transpiler/distribute_transpiler.py:132).

The reference rewrites one program into trainer programs (send/recv ops)
and pserver programs (listen_and_serv with an optimize block a parameter)
over gRPC.  The dense synchronous path is replaced by data parallelism:
``get_trainer_program`` returns the original program, to run with
``fluid.ParallelExecutor`` over ``torch.distributed`` (one process a rank,
gradients summed by one all-reduce a step).  The pserver programs are
stubs kept for API parity.

The sparse path annotates as the JAX package does: ``transpile()`` finds
every ``lookup_table`` with ``is_distributed`` set, marks the op local and
annotates the table and its optimizer accumulators row-sharded over the
mesh axis ``sparse_shard_axis``.  Running such a program on a
``ParallelExecutor`` raises: row-sharded tables are not ported yet
(ROADMAP.md, Queue 1 item 7).
"""

from ..framework import default_main_program, Program

__all__ = ['DistributeTranspiler', 'DistributeTranspilerConfig']


class DistributeTranspilerConfig(object):
    """(reference distribute_transpiler.py:116)"""

    slice_var_up = True
    split_method = None
    min_block_size = 8192
    # mesh axis the distributed lookup tables' rows shard over
    sparse_shard_axis = 'dp'


class DistributeTranspiler(object):
    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()
        self._transpiled = False

    def transpile(self,
                  trainer_id,
                  program=None,
                  pservers='127.0.0.1:6174',
                  trainers=1,
                  sync_mode=True,
                  startup_program=None):
        if program is None:
            program = default_main_program()
        if not sync_mode:
            raise NotImplementedError(
                'dense async parameter-server updates have no analog here '
                '(the dense path is synchronous data parallelism); the '
                'barrier-free sparse updates of the JAX package\'s '
                'distributed.AsyncSparseEmbedding are not ported to PyTorch '
                'yet (ROADMAP.md, Queue 1 item 9)')
        self.trainer_id = trainer_id
        self.trainers = trainers
        self.pserver_endpoints = [
            ep.strip() for ep in pservers.split(',') if ep.strip()
        ]
        self.origin_program = program
        program._is_distributed = True
        program._trainers = trainers
        program._trainer_id = trainer_id
        self.distributed_lookup_tables = _shard_distributed_tables(
            program, self.config.sparse_shard_axis)
        if startup_program is not None:
            _shard_distributed_tables(
                startup_program, self.config.sparse_shard_axis,
                only_names=set(self.distributed_lookup_tables))
        self._transpiled = True

    @property
    def has_distributed_lookup_table(self):
        """(reference distribute_transpiler.py has_distributed_lookup_table)"""
        if not self._transpiled:
            raise RuntimeError('call transpile() first')
        return bool(self.distributed_lookup_tables)

    def get_trainer_program(self):
        """The trainer program is the original program: run it with
        fluid.ParallelExecutor, whose ranks sum their gradients by an
        all-reduce rather than send/recv ops."""
        if not self._transpiled:
            raise RuntimeError('call transpile() first')
        return self.origin_program

    def get_pserver_program(self, endpoint):
        """A stub program whose single listen_and_serv op documents the
        mapping: dense synchronous training needs no pserver."""
        if not self._transpiled:
            raise RuntimeError('call transpile() first')
        prog = Program()
        prog.global_block().append_op(
            type='listen_and_serv',
            inputs={},
            outputs={},
            attrs={
                'endpoint': endpoint,
                'note': 'dense sync-SGD is data parallel; no pserver needed',
            })
        return prog

    def get_startup_program(self, endpoint, pserver_program=None):
        return Program()

    def get_pserver_programs(self, endpoint):
        """(main, startup) pair for one endpoint (reference
        get_pserver_programs): stubs, like get_pserver_program."""
        return (self.get_pserver_program(endpoint),
                self.get_startup_program(endpoint))


def _shard_distributed_tables(program, axis, only_names=None):
    """Annotate every ``lookup_table(is_distributed=True)`` table (and its
    optimizer accumulators) row-sharded over ``axis``, and mark the ops
    local.  Returns the sorted table names."""
    from ...parallel.api import shard, sharding_of, PartitionSpec

    if only_names is not None:
        # a startup program carries the same table vars but no
        # lookup_table ops: the caller names the tables to annotate
        tables = set(only_names)
    else:
        tables = set()
        for block in program.blocks:
            for op in block.ops:
                if op.type not in ('lookup_table', 'lookup_table_grad'):
                    continue
                if not op.attrs.get('is_distributed'):
                    continue
                op.attrs['remote_prefetch'] = False
                tables.add(op.input('W')[0])
    for block in program.blocks:
        for name in tables:
            w = block._find_var_recursive(name)
            if w is not None and sharding_of(w) is None:
                shard(w, PartitionSpec(axis, None))
        # optimizer accumulators co-locate with their table: ownership is
        # recorded at creation (Optimizer._add_accumulator tags vars)
        for v in block.vars.values():
            if (getattr(v, '_accumulator_for', None) in tables
                    and len(v.shape or ()) >= 2
                    and sharding_of(v) is None):
                shard(v, PartitionSpec(axis, None))
    if only_names is None:
        program._distributed_lookup_tables = sorted(tables)
    return sorted(tables)

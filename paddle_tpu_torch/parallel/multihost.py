"""Multi-process bootstrap on ``torch.distributed`` (counterpart of
``paddle_tpu/parallel/multihost.py``).

The reference's rendezvous went through an ``ncclUniqueId`` sent to every
trainer under the ``NCCLID`` var; the JAX package hands it to
``jax.distributed``.  Here one process runs each rank, and
``torch.distributed.init_process_group`` meets the others at a TCP store.
The env contract is the reference's:

    PADDLE_TRAINER_ID        -> rank
    PADDLE_TRAINERS_NUM      -> world size
    PADDLE_TRAINER_ENDPOINTS -> first endpoint = the store's address
    (or PADDLE_COORDINATOR   -> the store's address directly)

The backend is NCCL between cards and gloo on the CPU; ranks that share one
card ask for gloo.  Rank r runs on ``cuda:(r % device_count)``.
"""

import os

__all__ = ['init_distributed_env', 'parse_distributed_env',
           'parse_elastic_env', 'rank_device']


def parse_distributed_env(environ=None, require_id=True):
    """Resolve (coordinator_address, num_processes, process_id) from the
    PADDLE_* env contract; (None, 1, 0) when not configured.  With
    require_id, a multi-process env missing PADDLE_TRAINER_ID raises (the
    caller has no other id source)."""
    env = environ if environ is not None else os.environ
    num = int(env.get('PADDLE_TRAINERS_NUM', env.get('PADDLE_TRAINERS',
                                                     1)))
    pid_raw = env.get('PADDLE_TRAINER_ID')
    if require_id and num > 1 and pid_raw is None:
        # defaulting to 0 would make every process claim rank 0 and hang
        # the store waiting for the others: fail loudly instead
        raise ValueError(
            'PADDLE_TRAINERS_NUM=%d but PADDLE_TRAINER_ID is not set; '
            'every host must export its unique trainer id' % num)
    pid = int(pid_raw or 0)
    coordinator = env.get('PADDLE_COORDINATOR')
    if coordinator is None:
        endpoints = env.get('PADDLE_TRAINER_ENDPOINTS', '')
        first = endpoints.split(',')[0].strip()
        coordinator = first or None
    return coordinator, num, pid


def parse_elastic_env(environ=None):
    """(worker_id, master_endpoint) for an elastic trainer from the same
    PADDLE_* contract:

        PADDLE_TRAINER_ID       -> worker id ('trainer-<id>')
        WORKER_TAG              -> overrides the worker id
        PADDLE_MASTER_ENDPOINT  -> the MasterServer door
        (or MASTER_ENDPOINT     -> same, the test-harness spelling)

    master_endpoint is None when no master door is configured."""
    env = environ if environ is not None else os.environ
    _, _, pid = parse_distributed_env(env, require_id=False)
    worker_id = env.get('WORKER_TAG') or ('trainer-%d' % pid)
    endpoint = env.get('PADDLE_MASTER_ENDPOINT') or \
        env.get('MASTER_ENDPOINT')
    return worker_id, endpoint


def rank_device(rank, use_cuda=True):
    """The device rank ``rank`` computes on: ``cuda:(rank % device_count)``,
    or the CPU."""
    import torch
    if not use_cuda:
        return torch.device('cpu')
    if not torch.cuda.is_available():
        raise RuntimeError('rank %d: no CUDA card is available (pass '
                           'use_cuda=False to run on the CPU)' % rank)
    return torch.device('cuda', rank % torch.cuda.device_count())


def init_distributed_env(coordinator_address=None, num_processes=None,
                         process_id=None, backend=None, use_cuda=True):
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id`` (no-op for one process without an address).  Explicit
    arguments override the PADDLE_* env contract.  ``backend``: 'nccl' or
    'gloo'; by default NCCL with ``use_cuda`` and gloo without (ranks that
    share one card pass 'gloo').  Returns (num_processes, process_id)."""
    env_coord, env_num, env_pid = parse_distributed_env(
        require_id=(process_id is None))
    coordinator_address = coordinator_address or env_coord
    num_processes = num_processes if num_processes is not None else env_num
    process_id = process_id if process_id is not None else env_pid
    if num_processes <= 1 and coordinator_address is None:
        return 1, 0
    if coordinator_address is None:
        raise ValueError(
            'multi-process run (%d processes) needs a coordinator: set '
            'PADDLE_COORDINATOR or PADDLE_TRAINER_ENDPOINTS' %
            num_processes)
    import torch
    import torch.distributed as dist
    backend = backend or ('nccl' if use_cuda else 'gloo')
    if use_cuda:
        device = rank_device(process_id)
        if backend == 'nccl':
            torch.cuda.set_device(device)
    address = coordinator_address if '://' in coordinator_address else \
        'tcp://' + coordinator_address
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id)
    return num_processes, process_id

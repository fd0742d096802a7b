"""Start the ranks of a multi-GPU run as local processes.

The entry points' ``main`` runs through :func:`run`: under torchrun, or with
the config's ``coordinator_address``, the process joins its process group
and runs its rank; a config whose ``data_parallel`` (times the distill
head's ``model_parallel``) asks for more than one rank without a process
group starts that many processes here (:func:`spawn`), so ``data_parallel
8`` alone engages eight GPUs of the host, as ``Mesh: {data_parallel: 8}``
engages eight devices in the JAX package.

:func:`spawn` runs ``fn(*args)`` in ``nprocs`` fresh interpreters
(``torch.multiprocessing``'s spawn start method: ``fn`` is pickled by its
module's name, and the module must import in a new process).  The ranks
join one process group through a file store in a fresh temporary
directory; rank ``r`` sees ``LOCAL_RANK=r``, so a CUDA run puts it on
``cuda:r`` unless ``device`` names a card.  Rank 0's return value comes
back; a rank that raises fails the call and stops the others, and a run
that outlasts ``timeout`` seconds is stopped and raises ``TimeoutError``.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from os.path import join
from typing import Callable, Optional

import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device
from .mesh import (default_backend, maybe_initialize_distributed,
                   quiet_other_ranks)


def _rank_main(rank: int, nprocs: int, store: str, result: str,
               backend: Optional[str], device, fn: Callable, args) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    dev = resolve_device(device)
    dist.init_process_group(backend or default_backend(dev),
                            init_method=f"file://{store}",
                            world_size=nprocs, rank=rank)
    quiet_other_ranks()
    try:
        out = fn(*args)
        if rank == 0:
            with open(result, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, backend: Optional[str] = None,
          device=None, timeout: Optional[float] = None):
    """Rank 0's ``fn(*args)`` of ``nprocs`` local ranks (module docstring);
    ``backend`` None: NCCL on CUDA, gloo on the CPU."""
    with tempfile.TemporaryDirectory(prefix="openscene_ranks_") as tmp:
        result = join(tmp, "result.pkl")
        ctx = mp.start_processes(
            _rank_main, args=(nprocs, join(tmp, "store"), result, backend,
                              device, fn, args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                for p in ctx.processes:
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} ran "
                                   f"past {timeout}s; stopped")
        with open(result, "rb") as f:
            return pickle.load(f)


def run(fn: Callable, cfg, device=None, model_parallel: int = 1):
    """``fn(cfg, device)`` on every rank of the run the config asks for
    (module docstring); returns this process's result, or rank 0's when the
    ranks were started here."""
    if maybe_initialize_distributed(cfg, device):
        return fn(cfg, device)
    n = max(cfg.data_parallel, 1) * max(model_parallel, 1)
    if n == 1:
        return fn(cfg, device)
    return spawn(fn, n, cfg, device, device=device)

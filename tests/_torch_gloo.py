"""Gloo process groups on the CPU for the port's mesh tests.

:func:`one_rank_mesh` is a ``(data, model)`` ``DeviceMesh`` of one rank
in this process, on a gloo group it starts and destroys.

:func:`run_ranks` starts ``world`` processes (``spawn``), each joining a
gloo group on a ``file://`` store in ``work_dir`` with one torch thread,
runs ``fn(rank, world, *args)`` there and returns what each rank's call
returned (pickled to ``work_dir``). The spawn has its own time limit, so
a hang fails the calling test instead of eating the suite's; the ranks
are killed then. ``fn`` must be importable (a module-level function).
"""
import contextlib
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world, work_dir, fn, args):
    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(work_dir, 'store')}",
                            world_size=world, rank=rank)
    try:
        got = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(got, fh)


def run_ranks(fn, world, work_dir, *args, timeout=240.0):
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its
    own process of one gloo group."""
    os.makedirs(work_dir, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(world, work_dir, fn, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} gloo ranks did not finish in {timeout} s")
    out = []
    for rank in range(world):
        with open(os.path.join(work_dir, f"rank{rank}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


@contextlib.contextmanager
def one_rank_mesh():
    """A ``(1, 1)`` ``(data, model)`` mesh on a gloo group of this process
    alone, destroyed when the block ends."""
    from torch.distributed.device_mesh import init_device_mesh

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}",
                                world_size=1, rank=0)
        try:
            yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        finally:
            dist.destroy_process_group()

"""Process-group bootstrap and the one collective of the sharded
deployments (counterpart of `locus_tpu/parallel/distributed.py`).

The JAX package runs one program over a global mesh and lets the
compiler place the collectives. Here the deployment is SPMD over a
`torch.distributed` process group: one process per shard (rank), every
rank runs the same step on the same replicated inputs, map leaves are
local to the rank, and cross-shard results come from `gather_ranked`
over a subgroup of the mesh (`parallel.mesh`). JAX's `make_global` (each
process contributes its own shards of host-replicated inputs) becomes
`mesh.shard_state`: each rank slices its own shards out of the same
host-built state.
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from locus_tpu_torch import diagnostics


def init_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    timeout_s: float = 600.0,
) -> bool:
    """Join the process group. With no arguments, torchrun's environment
    variables (MASTER_ADDR, WORLD_SIZE, RANK) decide; without them this
    is a single process and nothing is initialised. `init_method` may be
    "file:///path" (a FileStore rendezvous: no TCP port to pick) or
    "tcp://host:port". `backend` defaults to "nccl" when a card is
    visible, else "gloo". Returns True when the group has more than one
    rank."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and world_size is None and "WORLD_SIZE" not in os.environ:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://", world_size=world_size if world_size is not None else -1,
        rank=rank if rank is not None else -1, timeout=timedelta(seconds=timeout_s),
    )
    return dist.get_world_size() > 1


def gather_ranked(x: torch.Tensor, mesh, axis: str = "map") -> list:
    """Every rank's `x` along `axis` of `mesh`, in the order of the ranks
    along that axis (the list form of `all_gather`). Every merge of the
    sharded deployments gathers with this and reduces the list in list
    order on every rank, so each rank computes the same bits; an
    `all_reduce` would sum in an order the backend picks.

    Deadlock: a collective returns only when every rank of the group has
    entered it. Every rank must therefore issue the same collectives in
    the same order, so no loop or branch around a call of this function
    may decide on a value local to one shard: loops read only replicated
    values (which every rank computes bit for bit alike), and a shard's
    own rows reach a decision only through this gather.

    gloo moves host memory: a tensor on the card is staged through the
    host explicitly, gathered, and moved back (nccl gathers on the card)."""
    group = mesh.group(axis)
    n = mesh.shape[axis]
    if group is None or n == 1:
        return [x]
    # the span that tools/torch_dist_smoke.py --trace-collectives reads
    with diagnostics.process_timer.time("gather_ranked"):
        staged = x.device.type == "cuda" and mesh.backend != "nccl"
        src = x.detach().cpu() if staged else x.detach()
        src = (src.to(torch.uint8) if x.dtype == torch.bool else src).contiguous()   # bools travel as bytes
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return [p.to(device=x.device, dtype=x.dtype) for p in parts]


def fetch_replicated(x: torch.Tensor):
    """A replicated tensor on the host as numpy. Every rank holds the whole
    value, so unlike the JAX function nothing moves between ranks."""
    return x.detach().cpu().numpy()


def local_batch_slice(mesh, batch_size: int) -> list:
    """The batch (sequence, robot) indices this rank feeds: the slice of
    the "data" axis its data row owns. Ranks of one data row feed the same
    robots (their map shards split those robots' maps)."""
    rows = mesh.shape["data"]
    if batch_size % rows:
        raise ValueError(f"a batch of {batch_size} does not split over {rows} data rows")
    per = batch_size // rows
    return list(range(mesh.data_index * per, (mesh.data_index + 1) * per))


def spawn_ranks(cmd: list, world_size: int, workdir, timeout_s: float, env=None, cwd=None) -> list:
    """Run `cmd` as `world_size` local ranks, each with `--rank r
    --world-size n --init-file <workdir>/store` appended (a FileStore
    rendezvous, so parallel launches never race for a TCP port), and wait
    for all of them. Ranks hang in a collective when another has died, so
    the first rank to fail, or the deadline, ends every rank. Returns
    (returncode, stdout, stderr) per rank; raises TimeoutError at the
    deadline. Each rank's output goes through `<workdir>/rank<r>.out|err`."""
    import contextlib
    import subprocess
    import time
    from pathlib import Path

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "store"
    store.unlink(missing_ok=True)
    with contextlib.ExitStack() as files:
        logs = [(files.enter_context(open(workdir / f"rank{r}.out", "w+")),
                 files.enter_context(open(workdir / f"rank{r}.err", "w+"))) for r in range(world_size)]
        procs = []
        try:
            for r, (out, err) in enumerate(logs):
                procs.append(subprocess.Popen(
                    [*map(str, cmd), "--rank", str(r), "--world-size", str(world_size), "--init-file", str(store)],
                    stdout=out, stderr=err, env=env, cwd=cwd,
                ))
            deadline = time.monotonic() + timeout_s
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break                              # the others would wait for it forever
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of {cmd[:2]} ran past {timeout_s} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results = []
        for p, (out, err) in zip(procs, logs):
            out.seek(0)
            err.seek(0)
            results.append((p.returncode, out.read(), err.read()))
    return results


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()

"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Sources live in `locus_tpu_torch/csrc/`; `build.py` compiles
them at first use.

The launch ledger: each wrapper records its launches through
`count_launch(row)`, by the row names of chip_smoke.py's `kernels` line.
`reset_launches` sets every row of this process to 0 and `read_launches`
reads them; a tool or the smoke script resets them just before the run it
measures and reads them just after. Where a launch counts is set by the
caller (`tally`): the ledger by default, nowhere inside `uncounted()`, and
a captured step's own tally while `ops.graph.CapturedStep` records it. A
replay of a captured step runs no wrapper: the graph hands each step's
account to the ledger (`keep_account`), and `read_launches` adds its
replays' launches, as counted at capture, first."""
import collections
import contextlib
import contextvars
import weakref

# The rows every read holds, 0 where nothing launched: B1, B2 (scan, map),
# B3 (scan, map), B4, B5, B6, B7's trips and the CUDA trips that ran its
# plain version, B8. B2/B3 at another chunk size than the pipeline's two (a
# sweep's) add `nn_visits[_batched]_bt<size>` once they launch.
ROWS = ("moments_visits", "nn_visits_scan", "nn_visits_map", "nn_visits_batched_scan", "nn_visits_batched_map",
        "moments_visits_batched", "moments_dense", "moments_dense_batched", "gicp_trip", "gicp_plain_trips",
        "eigh6")

_launches = collections.Counter()
# where a launch counts: None the ledger, else a Counter of the caller's
_tally = contextvars.ContextVar("locus_torch_launch_tally", default=None)
# the captured steps' accounts (`ops.graph`): `take(rows)` adds the launches
# of the replays since the last take to the Counter `rows`, `drop()` forgets them
_accounts = weakref.WeakSet()


def count_launch(row: str) -> None:
    """Record one launch (or plain CUDA trip) under `row`."""
    tally = _tally.get()
    (_launches if tally is None else tally)[row] += 1


@contextlib.contextmanager
def tally(into: collections.Counter):
    """Record the enclosed launches in `into`, not in the ledger."""
    token = _tally.set(into)
    try:
        yield into
    finally:
        _tally.reset(token)


def uncounted():
    """Record none of the enclosed launches (a comparison's, a warm-up's)."""
    return tally(collections.Counter())


def keep_account(account) -> None:
    """Add a captured step's replays (`take`, `drop`) to every read."""
    _accounts.add(account)


def reset_launches() -> None:
    """Set every kernel launch row of this process to 0, those of the
    captured steps' replays too."""
    _launches.clear()
    for account in list(_accounts):
        account.drop()


def raw_launches() -> dict:
    """The rows, without the captured steps' replays."""
    return {row: _launches[row] for row in ROWS} | {k: v for k, v in _launches.items() if k not in ROWS}


def read_launches() -> dict:
    """The rows (`raw_launches`), after adding the launches of the captured
    steps' replays since the last read (one host read per captured step
    that replayed)."""
    for account in list(_accounts):
        account.take(_launches)
    return raw_launches()

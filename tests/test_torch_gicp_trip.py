"""Kernel B7 (`csrc/gicp.cu`: one GICP trip after its 1-NN) against its
plain version, the trip of `registration/gicp.py` (inside
`dispatch.no_kernels()` on the card), and the choice between the two.

The CPU tests (tier 1) hold what the CPU can see: the calls that keep the
plain trip, the wrapper's checks, the launch grid against `gicp.cu`'s
constants, the launch counters' rows, and the kernel's order of summation
against `linalg.tree_sum`, mirrored in numpy.

The card tests (marker `gpu`; they skip without a card) compare the two
on the same inputs, on every case of tests/test_torch_gicp.py's CASES
(the same fixtures, made without JAX), at a capacity that is not a power
of two with masked rows, at the iteration cap with the re-lookup, on a
batch whose members stop on different trips, inside a captured step, and
stage by stage on one trip (its carry after 0, 1, ... inner steps).
Tolerances: exact. The kernel rounds every step as the plain version's
kernels do.

This file imports neither JAX nor anything from tests/, so the card's
machine runs it:

    python -m pytest --noconftest -m gpu tests/test_torch_gicp_trip.py
"""
import collections
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from locus_tpu_torch.config import RegistrationConfig
from locus_tpu_torch.core.cloud import PointCloud, take_rows
from locus_tpu_torch.geometry import se3
from locus_tpu_torch.io import synthetic
from locus_tpu_torch.ops import dispatch, graph, kernels
from locus_tpu_torch.ops.kernels import gicp as tgicp
from locus_tpu_torch.ops.kernels.nn import SCAN_BT, build_nn_target, chunk_boxes, nearest_bounded_raw, sq_norm3
from locus_tpu_torch.registration import gicp as rg
from locus_tpu_torch.utils.linalg import tree_sum


def _cube(capacity=1024, step=0.1, **kw):
    xyz, nrm = synthetic.hollow_cube(step=step, **kw)
    return xyz, nrm, capacity


def _T(w, t):
    R = se3.so3_exp(torch.tensor(w, dtype=torch.float32))
    return se3.make_transform(R, torch.tensor(t, dtype=torch.float32)).numpy()


# tests/test_torch_gicp.py's CASES
CASES = {
    "translation": dict(src=lambda: _cube(), T=_T([0, 0, 0], [0.05, 0.0, 0.0]), cfg=dict(corr_dist=1.0)),
    "rigid": dict(src=lambda: _cube(), T=_T([0.02, -0.03, 0.05], [0.04, -0.03, 0.02]), cfg={}),
    "warm_start": dict(src=lambda: _cube(), T=_T([0, 0, 0.3], [0.4, 0.1, 0.0]), cfg={},
                       guess=_T([0.02, 0.02, 0.32], [0.37, 0.07, -0.03])),
    "identity_gated": dict(src=lambda: _cube(), T=np.eye(4, dtype=np.float32), cfg=dict(corr_dist=0.5)),
    "iteration_cap": dict(src=lambda: _cube(), T=_T([0.0, 0.0, 0.04], [0.08, -0.05, 0.03]),
                          cfg=dict(iterations=2, final_correspondence_relookup=True)),
    "oracle_rotation": dict(src=lambda: _cube(capacity=2048, step=0.15, side=4.0, jitter=0.01, seed=7),
                            T=_T([0.01, -0.02, 0.04], [0.04, 0.02, -0.03]), cfg={}),
}


def _clouds(xyz, nrm, capacity, T, device, drop=None):
    """(source, target): the points as a cloud of `capacity` rows, the
    target the source moved by T. `drop` (indices) masks those rows out."""
    mask = np.ones(len(xyz), bool)
    if drop is not None:
        mask[drop] = False
    src = PointCloud.from_points(xyz, capacity=capacity, normals=nrm, mask=mask, device=device)
    return src, src.transform(torch.as_tensor(T, device=device))


def _case(name, device):
    c = CASES[name]
    xyz, nrm, capacity = c["src"]()
    src, tgt = _clouds(xyz, nrm, capacity, c["T"], device)
    guess = c.get("guess")
    return src, tgt, None if guess is None else torch.as_tensor(guess, device=device), RegistrationConfig(**c["cfg"])


def _both(src, tgt, guess, cfg):
    """(kernel result, plain result) of one call on the same inputs."""
    before = kernels.raw_launches()["gicp_trip"]
    fused = rg.gicp_register(src, tgt, guess, cfg)
    launched = kernels.raw_launches()["gicp_trip"] - before
    with dispatch.no_kernels():
        plain = rg.gicp_register(src, tgt, guess, cfg)
    return fused, plain, launched


def _assert_equal(a, b, what=""):
    for field in ("iterations", "converged", "num_correspondences", "correspondences", "corr_mask",
                  "transform", "fitness"):
        x, y = getattr(a, field).cpu(), getattr(b, field).cpu()
        assert torch.equal(x, y), f"{what}{field}: {x} != {y}"


# -- the CPU -------------------------------------------------------------------


def test_cpu_calls_and_full_covariances_keep_the_plain_trip():
    """A CPU call runs the plain trip in every covariance mode, with
    explicit covariances too, and counts nothing."""
    src, tgt, _, cfg = _case("rigid", "cpu")
    kernels.reset_launches()
    base = rg.gicp_register(src, tgt, None, cfg)
    for kw in (dict(covariance_mode="recompute"), dict(covariance_mode="adaptive"), dict(recompute_covariances=True)):
        res = rg.gicp_register(src, tgt, None, RegistrationConfig(**kw))
        assert int(res.iterations) >= 1
    cov = rg.covariance_from_normals(src.normals, cfg.gicp_epsilon)
    explicit = rg.gicp_register(src, tgt, None, cfg, source_cov=cov, target_cov=rg.covariance_from_normals(
        tgt.normals, cfg.gicp_epsilon))
    assert int(explicit.iterations) == int(base.iterations)
    rows = kernels.read_launches()
    assert rows["gicp_trip"] == 0 and rows["gicp_plain_trips"] == 0


def _operands(n=100, m=120, batch=None, device="cpu"):
    lead = () if batch is None else (batch,)
    f = lambda *s: torch.zeros(lead + s, dtype=torch.float32, device=device)
    source = (f(n, 3), f(n, 3), torch.ones(lead + (n,), dtype=torch.bool, device=device))
    target = (f(m, 3), f(m, 3), torch.ones(lead + (m,), dtype=torch.bool, device=device))
    carry = (f(4, 4), torch.zeros(lead, dtype=torch.int32), f(), f(), torch.zeros(lead, dtype=torch.int32),
             torch.zeros(lead + (n,), dtype=torch.int64), f(n), torch.ones((), dtype=torch.bool))
    return f(n, 3), torch.zeros(lead + (max(n, 128),), dtype=torch.int32), source, target, carry


@pytest.mark.parametrize("capacity,takes", [(1, True), (1000, True), (4096, True), (4097, True), (32768, True),
                                            (32769, False), (0, False)])
def test_the_kernel_takes_disks_up_to_its_capacity(capacity, takes):
    """Every disk-path CUDA call runs B7, whatever its capacity: the
    wrapper takes 1 to MAX_POINTS (32,768) source points a member and
    raises above, rather than fall back to the plain trip. Here the
    operands are on the CPU, so a capacity it takes fails only on the
    device."""
    assert tgicp.MAX_POINTS == 32768
    p, idx, source, target, carry = _operands(n=capacity)
    with pytest.raises(ValueError) as raised:
        tgicp.gicp_trip(p, idx, source, target, carry, RegistrationConfig())
    assert ("CUDA device" in str(raised.value)) == takes, raised.value


@pytest.mark.parametrize("fault", ["p_dtype", "idx_dtype", "mask_dtype", "carry_shape", "target_shape", "capacity",
                                   "device", "contiguous"])
def test_the_wrapper_checks_its_operands(fault):
    p, idx, source, target, carry = _operands()
    cfg = RegistrationConfig()
    if fault == "p_dtype":
        p = p.double()
    elif fault == "idx_dtype":
        idx = idx.long()
    elif fault == "mask_dtype":
        source = source[:2] + (source[2].to(torch.uint8),)
    elif fault == "carry_shape":
        carry = (carry[0][:3],) + carry[1:]
    elif fault == "target_shape":
        target = (target[0][:, :2],) + target[1:]
    elif fault == "capacity":
        p, idx, source, target, carry = _operands(n=tgicp.MAX_POINTS + 1)
        idx = torch.zeros(tgicp.MAX_POINTS + 64, dtype=torch.int32)
    elif fault == "contiguous":
        p = p.t().contiguous().t()
    # "device": every operand well formed, on the CPU
    with pytest.raises(ValueError):
        tgicp.gicp_trip(p, idx, source, target, carry, cfg)


def test_launch_grid_mirrors_gicp_cu():
    """One block of THREADS a member, a word of each of the COLUMNS
    columns (the 27 sums and the correspondences' 2) a thread in shared
    memory, within the H100's 227 KB."""
    src = (Path(tgicp.__file__).resolve().parents[2] / "csrc" / "gicp.cu").read_text()
    assert f"constexpr int THREADS = {tgicp.THREADS};" in src
    assert f"constexpr int MAX_LEAVES = {tgicp.MAX_LEAVES};" in src
    assert f"constexpr int TERMS = {tgicp.TERMS};" in src
    assert "constexpr int COLUMNS = TERMS + 2;" in src and tgicp.COLUMNS == tgicp.TERMS + 2 <= 32
    for leaves in (1, 2, 4, 8, 16, 32):   # an instance for every power of two up to MAX_LEAVES
        assert f"gicp_trip_kernel<{leaves}>" in src
    assert "const size_t bytes = COLUMNS * THREADS * sizeof(float);" in src
    for batch in (1, 3, 16):
        grid, threads, shared = tgicp.launch_grid(batch)
        assert grid == (batch, 1, 1) and threads == tgicp.THREADS
        assert shared == tgicp.COLUMNS * tgicp.THREADS * 4 <= 232448 - 1024


def test_launch_rows_count_the_trips():
    """`gicp_trip` and `gicp_plain_trips` are rows of the ledger:
    recorded, left out inside `uncounted()`, added from a captured step's
    gated region (a trip's launches times the trips it ran), and reset."""
    class Step:   # stands in for a CapturedStep (its record holds a weak reference)
        pass

    kernels.reset_launches()
    for row, n in (("gicp_trip", 3), ("gicp_plain_trips", 2)):
        for _ in range(n):
            kernels.count_launch(row)
    with kernels.uncounted():
        kernels.count_launch("gicp_trip")
    rows = kernels.raw_launches()
    assert (rows["gicp_trip"], rows["gicp_plain_trips"]) == (3, 2)
    step = Step()
    record = graph._Record(step, collections.Counter(), [collections.Counter(gicp_trip=1)],
                           torch.zeros(graph._MAX_REGIONS, dtype=torch.int64))
    graph._register(record)
    record.trips[0] += 4
    record.replays = 1
    rows = kernels.read_launches()
    assert (rows["gicp_trip"], rows["gicp_plain_trips"]) == (7, 2)
    kernels.reset_launches()
    rows = kernels.read_launches()
    assert (rows["gicp_trip"], rows["gicp_plain_trips"]) == (0, 0)


def test_masked_predicate_is_the_gates_and():
    """A kernel that writes in place takes `graph.predicate()`: None
    outside masked gates, the AND of the enclosing gates' predicates
    inside."""
    assert graph.predicate() is None
    seen = []
    yes, no = torch.tensor(True), torch.tensor(False)
    with graph.masked():
        assert graph.predicate() is None
        graph.gate(yes, lambda: seen.append(bool(graph.predicate())), trips=yes)
        graph.gate(no, lambda: seen.append(bool(graph.predicate())), trips=no)
    assert seen == [True, False]


def _kernel_order_sum(x: np.ndarray) -> np.float32:
    """gicp.cu's order of a column sum, in float32: each thread's K points
    (t + W k) taken in bit-reversed order of k, each added as the right
    half to the left halves waiting at the levels where its position has
    a 1 (`Sums::put`, a binary counter), then the halvings across threads
    in shared memory down to 32, then the shuffles."""
    threads = tgicp.THREADS
    n = len(x)
    size = 1 << max(n - 1, 0).bit_length()
    width = min(size, threads)
    leaves = size // width
    levels = leaves.bit_length() - 1
    xp = np.zeros(size, np.float32)
    xp[:n] = x
    waiting = {}
    for pos in range(leaves):
        k = int(format(pos, f"0{levels}b")[::-1], 2) if levels else 0
        v = xp[np.arange(width) + width * k]
        level = 0
        while pos >> level & 1:
            v = waiting.pop(level) + v
            level += 1
        waiting[level] = v
    s0 = waiting[levels].copy()
    s = width // 2
    while s >= 32:
        s0[:s] = s0[:s] + s0[s:2 * s]
        s //= 2
    lanes = np.zeros(32, np.float32)
    lanes[:min(width, 32)] = s0[:min(width, 32)]
    off = min(width, 32) // 2
    while off:
        lanes[:32 - off] = lanes[:32 - off] + lanes[off:]
        off //= 2
    return lanes[0]


@pytest.mark.parametrize("n", [1, 5, 33, 700, 1024, 1500, 2048, 3000, 4096, 6000, 9000, 20000, 32768])
def test_kernel_sum_order_is_tree_sum(n):
    """B7's column sums are `tree_sum`'s, bit for bit, at any capacity it
    takes: the same pairs added in the same order."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * np.exp(3 * rng.standard_normal(n))).astype(np.float32)
    x[rng.random(n) < 0.2] = 0.0
    want = tree_sum(torch.from_numpy(x), dim=-1).numpy()
    assert _kernel_order_sum(x).tobytes() == want.tobytes()


# -- the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The CUDA device; skips the test where there is none. Decided here,
    at run time, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_trip_kernel_matches_plain(cuda_device, case):
    src, tgt, guess, cfg = _case(case, cuda_device)
    fused, plain, launched = _both(src, tgt, guess, cfg)
    _assert_equal(fused, plain)
    assert launched == int(fused.iterations) >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("capacity,step", [(1000, 0.1), (3000, 0.1), (8000, 0.03), (20000, 0.02)])
def test_trip_kernel_odd_capacity_and_masked_rows(cuda_device, capacity, step):
    """A capacity that is not a power of two (padded to 1024, 4096, 8192
    or 32768 in the sums: 1, 4, 8 and 32 points a thread), masked rows
    inside the source and the target."""
    xyz, nrm, _ = _cube(step=step, side=1.0, jitter=0.002, seed=3)
    rng = np.random.default_rng(capacity)
    drop = rng.choice(len(xyz), size=len(xyz) // 7, replace=False)
    src, tgt = _clouds(xyz, nrm, capacity, _T([0.01, 0.02, -0.03], [0.03, -0.02, 0.01]), cuda_device, drop=drop)
    tgt = tgt._replace(mask=tgt.mask & torch.as_tensor(rng.random(capacity) > 0.1, device=cuda_device))
    fused, plain, _ = _both(src, tgt, None, RegistrationConfig())
    _assert_equal(fused, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("inner", [1, 3, 5])
def test_trip_kernel_at_the_iteration_cap(cuda_device, inner):
    """The loop stops at its cap, unconverged, and the re-lookup runs."""
    src, tgt, _, _ = _case("iteration_cap", cuda_device)
    cfg = RegistrationConfig(iterations=1, inner_iterations=inner, final_correspondence_relookup=True)
    fused, plain, launched = _both(src, tgt, None, cfg)
    _assert_equal(fused, plain)
    assert int(fused.iterations) == 1 == launched and not bool(fused.converged)


@pytest.mark.gpu
def test_trip_kernel_batch_members_stop_on_different_trips(cuda_device):
    """Three members in one launch a trip, each equal to its single call
    (kernel and plain), stopping after different numbers of trips."""
    xyz, nrm, cap = _cube()
    motions = [_T([0, 0, 0.001], [0.002, 0, 0]), _T([0.02, -0.03, 0.05], [0.04, -0.03, 0.02]),
               _T([0.0, 0.05, 0.12], [0.15, 0.1, -0.05])]
    pairs = [_clouds(xyz, nrm, cap, T, cuda_device) for T in motions]
    src = PointCloud(*(torch.stack(parts) for parts in zip(*(s for s, _ in pairs))))
    tgt = PointCloud(*(torch.stack(parts) for parts in zip(*(t for _, t in pairs))))
    cfg = RegistrationConfig()
    fused, plain, _ = _both(src, tgt, None, cfg)
    _assert_equal(fused, plain, "batched: ")
    assert len(set(fused.iterations.tolist())) > 1, fused.iterations
    for b, (s, t) in enumerate(pairs):
        single = rg.gicp_register(s, t, None, cfg)
        member = type(fused)(*(x[b] for x in fused))
        _assert_equal(member, single, f"member {b}: ")


@pytest.mark.gpu
def test_trip_kernel_in_a_captured_step_matches_eager(cuda_device):
    """The trips as IF-node bodies of a CUDA graph (warmed up in masked
    mode, where the kernel takes the gates' predicate): each replay equals
    the eager call, and the launches counted at capture add up to the
    trips the replays ran."""
    cfg = RegistrationConfig()
    inputs = []
    for name in ("rigid", "translation"):
        src, tgt, _, _ = _case(name, cuda_device)
        inputs.append((src.xyz, src.normals, src.mask, tgt.xyz, tgt.normals, tgt.mask))

    def fn(state, sx, sn, sm, tx, tn, tm):
        zeros = torch.zeros(sm.shape, dtype=torch.float32, device=sm.device)
        res = rg.gicp_register(PointCloud(sx, sn, zeros, sm), PointCloud(tx, tn, zeros, tm), None, cfg)
        return state, res

    eager = [fn(None, *x)[1] for x in inputs]
    step = graph.CapturedStep(fn, "test.gicp_trip")
    state = (torch.zeros(1, device=cuda_device),)
    kernels.reset_launches()
    for x, want in zip(inputs, eager):
        _, got = step(state, *x)
        _assert_equal(got, want, "captured: ")
    rows = kernels.read_launches()
    assert rows["gicp_trip"] == sum(int(r.iterations) for r in eager), rows
    assert rows["gicp_plain_trips"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["recompute", "adaptive", "explicit"])
def test_full_covariances_keep_the_plain_trip_on_the_card(cuda_device, mode):
    """Covariances that are full 3x3 matrices run the plain trip on the
    card too, counted in the row `gicp_plain_trips`, with the plain result."""
    src, tgt, _, cfg = _case("rigid", cuda_device)
    kw = {}
    if mode == "explicit":
        kw = dict(source_cov=rg.covariance_from_normals(src.normals, cfg.gicp_epsilon),
                  target_cov=rg.covariance_from_normals(tgt.normals, cfg.gicp_epsilon))
    else:
        cfg = RegistrationConfig(covariance_mode=mode)
    kernels.reset_launches()
    res = rg.gicp_register(src, tgt, None, cfg, **kw)
    rows = kernels.read_launches()
    assert rows["gicp_trip"] == 0 and rows["gicp_plain_trips"] == int(res.iterations) >= 1
    with dispatch.no_kernels():
        plain = rg.gicp_register(src, tgt, None, cfg, **kw)
    _assert_equal(res, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["rigid", "warm_start", "oracle_rotation"])
def test_trip_kernel_stages_match_plain(cuda_device, case):
    """One first trip, stage by stage: the kernel's carry after 0, 1, ...
    inner steps (one launch each, on a fresh carry) against the plain
    version's, built from the trip's own functions: the pairs and their
    distances, the correspondence sums (fitness, count), the transform
    after each inner step (orthonormalised) and the convergence metric."""
    src, tgt, guess, cfg = _case(case, cuda_device)
    guess = se3.identity(cuda_device) if guess is None else guess
    n, m = src.capacity, tgt.capacity
    src0 = torch.where(src.mask[..., None], se3.transform_points(guess, src.xyz), src.xyz)
    src0_n = se3.rotate_vectors(guess, src.normals)
    t_aug = build_nn_target(tgt.xyz, bt=SCAN_BT)
    c_min, c_max = chunk_boxes(tgt.xyz, tgt.mask, t_aug.shape[-2], bt=SCAN_BT)
    T = se3.identity(cuda_device).clone()
    p = se3.transform_points(T, src0)
    _, i = nearest_bounded_raw(p, t_aug, c_min, c_max, float(cfg.corr_dist), bt=SCAN_BT)

    r2 = cfg.corr_dist * cfg.corr_dist
    j = torch.clamp(i[:n].to(torch.int64), 0, m - 1)
    d2 = sq_norm3(p - take_rows(tgt.xyz, j))
    d2 = torch.where(d2 <= r2, d2, float("inf"))
    d2 = torch.where(torch.isfinite(d2), d2, 1e12)
    w = (src.mask & take_rows(tgt.mask, j) & (d2 <= r2)).to(torch.float32)
    wsum = tree_sum(w, dim=-1)
    q = take_rows(tgt.xyz, j)
    M = rg._inv_sym3(rg._sym3_two_disks(se3.rotate_vectors(T, src0_n), take_rows(tgt.normals, j), cfg.gicp_epsilon))
    stages, Tn = [], T
    for inner in range(cfg.inner_iterations + 1):
        if inner:
            p_cur = torch.where(src.mask[..., None], se3.transform_points(Tn, src0), q)
            dx = rg._gauss_newton_solve(rg._gauss_newton_sums(p_cur, q, M, w), cfg.levenberg_lambda)
            Tn = se3.compose(se3.se3_exp(dx), Tn)
        Tf = se3.make_transform(se3.orthonormalize(se3.rotation(Tn)), se3.translation(Tn))
        carry = (T.clone(), torch.zeros((), dtype=torch.int32, device=cuda_device),
                 torch.full((), float("inf"), device=cuda_device), torch.zeros((), device=cuda_device),
                 torch.zeros((), dtype=torch.int32, device=cuda_device),
                 torch.zeros(n, dtype=torch.int64, device=cuda_device), torch.zeros(n, device=cuda_device),
                 torch.ones((), dtype=torch.bool, device=cuda_device))
        tgicp.gicp_trip(p, i, (src0, src0_n, src.mask), (tgt.xyz, tgt.normals, tgt.mask), carry,
                        dataclasses.replace(cfg, inner_iterations=inner))
        got_T, got_it, got_delta, got_fit, got_ncorr, got_j, got_d2, _ = carry
        stages += [
            (f"inner {inner}: pairs", got_j, j), (f"inner {inner}: distances", got_d2, d2),
            (f"inner {inner}: fitness", got_fit, tree_sum(d2 * w, dim=-1) / torch.clamp(wsum, min=1.0)),
            (f"inner {inner}: count", got_ncorr, wsum.to(torch.int32)),
            (f"inner {inner}: transform", got_T, Tf),
            (f"inner {inner}: convergence metric", got_delta, rg._scaled_delta(T, Tf, cfg)),
        ]
        assert int(got_it) == 1
    report = [(name, float((a.double() - b.double()).abs().max()), torch.equal(a, b)) for name, a, b in stages]
    assert all(same for _, _, same in report), report

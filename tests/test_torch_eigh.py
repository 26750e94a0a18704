"""Kernel B8 (`csrc/eigh.cu`: the float64 6x6 Jacobi eigendecomposition of
the covariance's Ap) against its plain version, `utils/linalg.py::
jacobi_eigh` of the symmetric part (`eigh.plain_eigh6`; inside
`dispatch.no_kernels()` on the card), and the path `eigh6` takes.

The CPU tests (tier 1) hold what the CPU can see: CPU calls return the
plain version's bits and count nothing, `measurement_update` reaches the
wrapper, the launch counters' row, the kernel's rounds and grid against
the plain version's schedule and the wrapper's constants, and the
kernel's arithmetic mirrored in Python (exact FMAs) against the plain
version's bits recorded on an H100.

The card tests (marker `gpu`; they skip without a card) compare the two
on random SPD matrices, on special ones (diagonal, equal diagonals,
repeated eigenvalues, zero, NaN), on the Ap of every sweep of a 240-sweep
Spot replay and of a 4-robot fleet, batched against single, inside a
captured step, and the replays' poses and outputs with kernels against
`no_kernels()`. Tolerances: exact against the plain version's batched
products (two or more members). cuBLAS takes a batch of one 6x6 product
in another order, so there the two agree to the last places of float64: eigenvalues and V diag(w) V^T within 1e-12 max|w|, the f32
covariance, condition number and eigenvalues within 1 ulp.

This file imports neither JAX nor anything from tests/, so the card's
machine runs it:

    python -m pytest --noconftest -m gpu tests/test_torch_eigh.py
"""
import collections
import inspect
import math
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from locus_tpu_torch import config as cfg_mod, localization, pipeline, runner
from locus_tpu_torch.core.cloud import PointCloud
from locus_tpu_torch.io import synthetic
from locus_tpu_torch.io.dataset import make_tunnel_sequence
from locus_tpu_torch.ops import dispatch, graph, kernels
from locus_tpu_torch.ops.kernels import eigh as teigh
from locus_tpu_torch.utils.linalg import _round_robin_rounds, jacobi_eigh

SOURCE = Path(teigh.__file__).resolve().parents[2] / "csrc" / "eigh.cu"
RECORDED = Path(__file__).resolve().parent / "data" / "eigh_card_plain.npz"


@pytest.fixture
def cuda_device():
    """The CUDA device; skips the test where there is none. Decided here,
    at run time, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spd(n, seed=0, low=-8.0, high=3.0):
    """n random symmetric positive definite 6x6 matrices, spectra
    log-uniform in [10^low, 10^high], made slightly asymmetric (as a
    summed Ap may be), float64."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, 6, 6)))
    lam = 10.0 ** rng.uniform(low, high, (n, 6))
    A = Q @ (lam[:, :, None] * Q.transpose(0, 2, 1))
    return A * (1.0 + 1e-15 * rng.standard_normal(A.shape))


def _bits(x):
    return x.detach().cpu().contiguous().view(torch.int64)


def _assert_bits(got, want, what=""):
    for name, a, b in zip(("eigenvalues", "eigenvectors"), got, want):
        assert torch.equal(_bits(a), _bits(b)), f"{what}{name}: max |diff| {float((a - b).abs().max())}"


# -- the CPU -------------------------------------------------------------------


@pytest.mark.parametrize("lead", [(), (1,), (4,), (2, 3)])
def test_cpu_calls_return_the_plain_version(lead):
    """A CPU tensor takes `jacobi_eigh` of the symmetric part, bit for
    bit, whatever the leading shape, and counts no launch."""
    n = int(np.prod(lead)) if lead else 1
    Ap = torch.as_tensor(_spd(n, seed=n)).reshape(lead + (6, 6))
    kernels.reset_launches()
    got = teigh.eigh6(Ap)
    _assert_bits(got, jacobi_eigh(0.5 * (Ap + Ap.transpose(-1, -2))))
    assert got[0].shape == lead + (6,) and got[1].shape == lead + (6, 6)
    assert kernels.read_launches()["eigh6"] == 0


def test_cpu_observability_and_covariance_use_the_wrapper():
    """`compute_observability` and `point2plane_covariance` return the
    wrapper's result on the CPU: the plain version's bits."""
    Ap = torch.as_tensor(_spd(1, seed=5)[0])
    _assert_bits(localization.compute_observability(Ap), teigh.plain_eigh6(Ap))
    cov, cond = localization.point2plane_covariance(Ap, 0.01)
    want = localization.covariance_from_ap_eig(*teigh.plain_eigh6(Ap), 0.01)
    assert torch.equal(cov, want[0]) and torch.equal(cond, want[1])


@pytest.mark.parametrize("covariance,observability,calls", [(True, False, 1), (False, True, 1), (False, False, 0)])
def test_measurement_update_reaches_the_wrapper(monkeypatch, covariance, observability, calls):
    """`measurement_update` decomposes its float64 Ap through the wrapper,
    once, where the covariance or the observability is asked for, and
    its outputs are the wrapper's."""
    seen = []

    def spy(Ap):
        seen.append(Ap.clone())
        return teigh.eigh6(Ap)

    monkeypatch.setattr(localization, "eigh6", spy)
    xyz, nrm = synthetic.plane(nx=20, ny=20, step=0.1, z=0.0)
    query = PointCloud.from_points(xyz, capacity=512, normals=nrm, device="cpu")
    T = torch.eye(4)
    T[2, 3] = 0.03
    cfg = cfg_mod.LocalizationConfig(compute_icp_covariance=covariance, compute_icp_observability=observability)
    res = localization.measurement_update(localization.init_state(device="cpu"), query, query.transform(T), cfg=cfg)
    assert len(seen) == calls
    if not calls:
        return
    Ap = seen[0]
    assert Ap.dtype == torch.float64 and Ap.shape == (6, 6)
    assert torch.equal(res.state.observability_matrix, Ap.float())
    w, v = teigh.plain_eigh6(Ap)
    if covariance:
        cov, cond = localization.covariance_from_ap_eig(w, v, cfg.icp_max_covariance)
        assert torch.equal(res.state.covariance, cov.float()) and torch.equal(res.state.condition_number, cond.float())
    else:
        assert torch.equal(res.state.observability_eigenvalues, w.float())


def test_launch_row_counts_the_kernel():
    """`eigh6` is a row of the ledger: recorded, left out inside
    `uncounted()`, added from a captured step's replays, and reset."""
    class Step:   # stands in for a CapturedStep (its record holds a weak reference)
        pass

    kernels.reset_launches()
    for _ in range(3):
        kernels.count_launch("eigh6")
    with kernels.uncounted():
        kernels.count_launch("eigh6")
    assert kernels.raw_launches()["eigh6"] == 3 and kernels.read_launches()["eigh6"] == 3
    step = Step()
    record = graph._Record(step, collections.Counter(eigh6=2), [], torch.zeros(graph._MAX_REGIONS, dtype=torch.int64))
    graph._register(record)
    record.replays = 2
    assert kernels.raw_launches()["eigh6"] == 3 and kernels.read_launches()["eigh6"] == 7
    kernels.reset_launches()
    assert kernels.read_launches()["eigh6"] == 0


def test_kernel_runs_the_plain_schedule():
    """eigh.cu's rounds are `_round_robin_rounds(6)` in order, each (p, q)
    with p < q; its sweeps are `jacobi_eigh`'s default; its members a
    block are the wrapper's WARPS; it is a kernel the pipeline builds,
    with nothing contracted into an FMA."""
    from locus_tpu_torch.ops.kernels import build

    src = SOURCE.read_text()
    rounds = [tuple(int(x) for x in m.split(",")) for m in re.findall(r"jacobi_round<([\d, ]+)>\(m, u, lane\)", src)]
    want = [tuple(i for pair in r for i in pair) for r in _round_robin_rounds(6)]
    assert rounds == want
    assert int(re.search(r"constexpr int SWEEPS = (\d+);", src).group(1)) == \
        inspect.signature(jacobi_eigh).parameters["sweeps"].default
    assert int(re.search(r"constexpr int WARPS = (\d+);", src).group(1)) == teigh.WARPS
    assert "eigh" in build.KERNELS and "-fmad=false" in build.EXTRA_FLAGS["eigh"]


@pytest.mark.parametrize("batch", [1, 4, 5, 240])
def test_launch_grid_covers_every_member(batch):
    """A warp a member, WARPS members a block: every member has its warp,
    and no block is wholly idle."""
    grid, threads = teigh.launch_grid(batch)
    assert threads == 32 * teigh.WARPS
    assert grid[0] * teigh.WARPS >= batch > (grid[0] - 1) * teigh.WARPS and grid[1:] == (1, 1)


def _fma(a, b, c):
    """fma(a, b, c) in float64, rounded once (exact rational arithmetic;
    Python's int division rounds correctly)."""
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    if exact:
        return float(exact)
    return -0.0 if math.copysign(1.0, a * b) < 0 and math.copysign(1.0, c) < 0 else 0.0


def _mirror(ap):
    """eigh.cu's arithmetic on one matrix, in Python floats: the rotation
    op by op, every product entry fma(x_q, g_q, fma(x_p, g_p, 0))."""
    a = ap.tolist()
    m = [[0.5 * (s + s) for s in (0.5 * (a[i][j] + a[j][i]) for j in range(6))] for i in range(6)]
    v = [[1.0 if i == j else 0.0 for j in range(6)] for i in range(6)]
    mix = lambda xp, gp, xq, gq: _fma(xq, gq, _fma(xp, gp, 0.0))
    for _ in range(6):
        for pairs in _round_robin_rounds(6):
            rots = []
            for p, q in pairs:
                app, aqq, apq = m[p][p], m[q][q], m[p][q]
                tau = (aqq - app) / (2.0 * (1e-30 if abs(apq) < 1e-30 else apq))
                t = float((0.0 < tau) - (tau < 0.0)) / (abs(tau) + math.sqrt(1.0 + tau * tau))
                if abs(apq) < 1e-12 * (abs(app) + abs(aqq) + 1e-30):
                    t = 0.0
                c = 1.0 / math.sqrt(1.0 + t * t)
                rots.append((p, q, c, t * c))
            rows = [r[:] for r in m]
            for p, q, c, s in rots:
                for j in range(6):
                    rows[p][j] = mix(m[p][j], c, m[q][j], -s)
                    rows[q][j] = mix(m[p][j], s, m[q][j], c)
            for row in rows + v:
                for p, q, c, s in rots:
                    row[p], row[q] = mix(row[p], c, row[q], -s), mix(row[p], s, row[q], c)
            m = rows
    order = sorted(range(6), key=lambda k: m[k][k])
    return np.array([m[k][k] for k in order]), np.array([[r[k] for k in order] for r in v])


def test_kernel_arithmetic_matches_the_cards_plain_bits():
    """The kernel's rounding, mirrored in Python, equals `jacobi_eigh`'s
    bits as an H100 computed them for 8 random SPD matrices in batches
    of 4 and 64 (PyTorch 2.11, CUDA 12.8: cuBLAS's batched double GEMM
    takes each entry as an FMA chain over k from +0), and lies within
    1e-12 of the CPU's plain version."""
    rec = np.load(RECORDED)
    for b, (ap, w, v) in enumerate(zip(rec["ap"], rec["eigvals"], rec["eigvecs"])):
        mw, mv = _mirror(ap)
        assert np.array_equal(mw.view(np.int64), w.view(np.int64)), f"matrix {b}: eigenvalues"
        assert np.array_equal(mv.view(np.int64), v.view(np.int64)), f"matrix {b}: eigenvectors"
        cw, cv = (x.numpy() for x in teigh.plain_eigh6(torch.as_tensor(ap)))
        scale = np.abs(w).max()
        assert np.abs(cw - mw).max() <= 1e-12 * scale
        assert np.abs((cv * cw) @ cv.T - (mv * mw) @ mv.T).max() <= 1e-12 * scale


# -- the card ------------------------------------------------------------------


def _close_to_plain(got, want):
    """Eigenvalues and V diag(w) V^T within 1e-12 max|w| of the plain
    version's; returns the largest differences (eigenvalues, products),
    relative to max|w| (a zero matrix's to 1e-300)."""
    (w, v), (pw, pv) = got, want
    scale = pw.abs().amax(-1).clamp(min=1e-300)
    dw = float(((w - pw).abs().amax(-1) / scale).max())
    rec = lambda w, v: (v * w[..., None, :]) @ v.transpose(-1, -2)
    dp = float(((rec(w, v) - rec(pw, pv)).abs().amax((-2, -1)) / scale).max())
    assert dw <= 1e-12 and dp <= 1e-12, (dw, dp)
    return dw, dp


def _ulps(a, b):
    """The distance in f32 units in the last place, elementwise."""
    ia, ib = (x.float().contiguous().view(torch.int32).to(torch.int64) for x in (a, b))
    ia, ib = (torch.where(x < 0, -(x & 0x7FFFFFFF), x) for x in (ia, ib))
    return (ia - ib).abs()


def _within_one_ulp(got, want):
    """The f32 covariance, condition number and eigenvalues that the step
    keeps, from the kernel's and the plain version's eigenpairs: at most
    1 ulp apart."""
    cov, cond = localization.covariance_from_ap_eig(*got, 0.01)
    pcov, pcond = localization.covariance_from_ap_eig(*want, 0.01)
    worst = {k: int(_ulps(a, b).max()) for k, a, b in
             (("covariance", cov, pcov), ("condition", cond, pcond), ("eigenvalues", got[0], want[0]))}
    assert max(worst.values()) <= 1, worst
    return worst


@pytest.mark.gpu
def test_kernel_matches_plain_on_random_spd(cuda_device):
    """200 SPD matrices, spectra 1e-8 to 1e3: one launch against the plain
    version (and `no_kernels()`) bit for bit; each matrix alone equals
    its member of the batch, and lies within the tolerances of the plain
    version's unbatched call."""
    Ap = torch.as_tensor(_spd(200, seed=1), device=cuda_device)
    kernels.reset_launches()
    got = teigh.eigh6(Ap)
    assert kernels.read_launches()["eigh6"] == 1
    _assert_bits(got, teigh.plain_eigh6(Ap), "plain: ")
    with dispatch.no_kernels():
        _assert_bits(got, teigh.eigh6(Ap), "no_kernels: ")
    assert kernels.read_launches()["eigh6"] == 1
    for i in range(Ap.shape[0]):
        single = teigh.eigh6(Ap[i])
        _assert_bits(single, (got[0][i], got[1][i]), f"matrix {i} alone: ")
        _close_to_plain(single, teigh.plain_eigh6(Ap[i]))


def _special(name):
    rng = np.random.default_rng(4)
    Q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    return {
        "diagonal": np.diag([3.0, 1.0, 2.0, 5.0, 4.0, 0.5]),                    # apq == 0
        "equal_diagonals": np.full((6, 6), 0.25) + np.eye(6),                   # tau == 0 everywhere
        "equal_diagonal_pair": np.diag([2.0, 2.0, 1.0, 3.0, 4.0, 5.0]) + 0.1 * (np.eye(6, k=1) + np.eye(6, k=-1)),
        "repeated": Q @ np.diag([1.0, 1.0, 2.0, 2.0, 2.0, 3.0]) @ Q.T,
        "repeated_diagonal": np.diag([1.0, 1.0, 2.0, 2.0, 2.0, 3.0]),
        "zero": np.zeros((6, 6)),
        "tiny": 1e-31 * (Q @ np.diag([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) @ Q.T),   # apq under the 1e-30 guard
    }[name]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["diagonal", "equal_diagonals", "equal_diagonal_pair", "repeated",
                                  "repeated_diagonal", "zero", "tiny"])
def test_kernel_matches_plain_on_special_matrices(cuda_device, name):
    """Each special matrix, as a member of a batch of two and alone: the
    plain version's bits in the batch, the tolerances alone."""
    a = torch.as_tensor(_special(name), device=cuda_device)
    pair = torch.stack([a, a.T.contiguous()])
    got = teigh.eigh6(pair)
    _assert_bits(got, teigh.plain_eigh6(pair))
    single = teigh.eigh6(a)
    _assert_bits(single, (got[0][0], got[1][0]), "alone: ")
    if name != "zero":
        _close_to_plain(single, teigh.plain_eigh6(a))
    else:
        _assert_bits(single, teigh.plain_eigh6(a), "alone: ")


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["nan", "inf"])
def test_a_non_finite_entry_reaches_the_eigenvectors(cuda_device, entry):
    """A NaN or inf in Ap makes every eigenvalue and eigenvector entry NaN,
    as in the plain version, so `covariance_from_ap_eig` falls back to
    icp_max_covariance times the identity; the other members are
    untouched."""
    A = _spd(3, seed=2)
    A[1, 2, 3] = np.nan if entry == "nan" else np.inf
    Ap = torch.as_tensor(A, device=cuda_device)
    w, v = teigh.eigh6(Ap)
    pw, pv = teigh.plain_eigh6(Ap)
    assert torch.isnan(w[1]).all() and torch.isnan(v[1]).all()
    assert torch.equal(torch.isnan(w), torch.isnan(pw)) and torch.equal(torch.isnan(v), torch.isnan(pv))
    for b in (0, 2):
        _assert_bits((w[b], v[b]), (pw[b], pv[b]), f"member {b}: ")
    cov, _ = localization.covariance_from_ap_eig(w, v, 0.01)
    assert torch.equal(cov[1], 0.01 * torch.eye(6, dtype=torch.float64, device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("lead", [(4,), (1,), (2, 3)])
def test_batched_equals_single(cuda_device, lead):
    """Every member of a batch of any leading shape equals its own call
    on the (6, 6) matrix, bit for bit."""
    n = int(np.prod(lead))
    Ap = torch.as_tensor(_spd(n, seed=3), device=cuda_device).reshape(lead + (6, 6))
    w, v = teigh.eigh6(Ap)
    assert w.shape == lead + (6,) and v.shape == lead + (6, 6)
    for idx in np.ndindex(*lead):
        _assert_bits(teigh.eigh6(Ap[idx]), (w[idx], v[idx]), f"member {idx}: ")


@pytest.mark.gpu
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    """A CUDA input that is not float64 of shape (..., 6, 6) raises; no
    call falls back to the plain version."""
    Ap = torch.as_tensor(_spd(2, seed=4), device=cuda_device)
    for bad in (Ap.float(), Ap[..., :5, :5], Ap[0, 0], Ap.reshape(2, 36), Ap.to(torch.int64)):
        with pytest.raises(ValueError, match="locus_eigh6"):
            teigh.eigh6(bad)
    with dispatch.no_kernels():
        teigh.eigh6(Ap.float())       # the plain version takes what torch takes


@pytest.mark.gpu
def test_kernel_in_a_captured_step_matches_eager(cuda_device):
    """B8 as a node of a CUDA graph: each replay equals the eager call, and
    the launch counted at capture adds one a replay."""
    inputs = [torch.as_tensor(_spd(1, seed=s)[0], device=cuda_device) for s in (6, 7, 8)]
    eager = [teigh.eigh6(a) for a in inputs]

    def fn(state, Ap):
        w, v = localization.compute_observability(Ap)
        return state, (w, v, localization.covariance_from_ap_eig(w, v, 0.01)[0])

    step = graph.CapturedStep(fn, "test.eigh6")
    state = (torch.zeros(1, device=cuda_device),)
    kernels.reset_launches()
    for a, want in zip(inputs, eager):
        _, (w, v, cov) = step(state, a)
        _assert_bits((w, v), want, "captured: ")
        assert torch.equal(cov, localization.covariance_from_ap_eig(*want, 0.01)[0])
    assert kernels.read_launches()["eigh6"] == len(inputs)


def _spot_cfg():
    """LOCUS's Spot profile (`LocusConfig.robot_profile("spot")`: the IMU
    prior, 25 scan-to-submap trips) at bench.py's production shapes."""
    spot = cfg_mod.LocusConfig.robot_profile("spot")
    return cfg_mod.production_config().replace(fusion=spot.fusion, localization=spot.localization)


ROBOTS, SWEEPS, FLEET_EAGER_TICKS = 4, 240, 24


def _recorded_aps(monkeypatch, cfg, state, packed):
    """The float64 Ap of every sweep (or tick) of an eager replay through
    the kernels, as `measurement_update` hands it to the wrapper."""
    seen = []

    def record(Ap):
        seen.append(Ap.clone())
        return teigh.eigh6(Ap)

    monkeypatch.setattr(localization, "eigh6", record)
    runner._replay(cfg, state, packed, None)
    monkeypatch.undo()
    return torch.stack(seen)


@pytest.mark.gpu
def test_kernel_matches_plain_on_a_spot_replays_sweeps(cuda_device, monkeypatch):
    """The Ap of every sweep of a 240-sweep Spot pass down the tunnel (its
    degenerate axis included): the sweeps in one launch equal the plain
    version's batch bit for bit; each sweep alone, as the step calls it,
    equals its member and lies within the tolerances of the plain
    version's unbatched call, its f32 covariance, condition number and
    eigenvalues within 1 ulp."""
    cfg = _spot_cfg()
    seq = make_tunnel_sequence(num_scans=SWEEPS, azimuth_steps=1800, step=0.16, seed=0)
    state = pipeline.init_state(cfg, initial_pose=torch.as_tensor(seq.gt_poses[0], dtype=torch.float32))
    aps = _recorded_aps(monkeypatch, cfg, state, runner.pack_sequence(seq, cfg))
    assert aps.shape == (SWEEPS, 6, 6) and aps.dtype == torch.float64
    got = teigh.eigh6(aps)
    _assert_bits(got, teigh.plain_eigh6(aps), "batched: ")
    worst = {}
    for i in range(SWEEPS):
        single = teigh.eigh6(aps[i])
        _assert_bits(single, (got[0][i], got[1][i]), f"sweep {i}: ")
        plain = teigh.plain_eigh6(aps[i])
        _close_to_plain(single, plain)
        for k, u in _within_one_ulp(single, plain).items():
            worst[k] = max(worst.get(k, 0), u)
    print("spot sweeps, ulps against the plain unbatched call:", worst)


@pytest.mark.gpu
def test_kernel_matches_plain_on_a_fleets_ticks(cuda_device, monkeypatch):
    """The (4, 6, 6) Ap of each tick of a 4-Spot fleet's eager batched
    replay: the kernel's launch equals the plain version's batch bit for
    bit, and each member its own call."""
    cfg = _spot_cfg()
    seqs = [make_tunnel_sequence(num_scans=FLEET_EAGER_TICKS, azimuth_steps=1800, step=0.16, seed=b)
            for b in range(ROBOTS)]
    stacked = runner.stack_packed([runner.pack_sequence(s, cfg) for s in seqs])
    aps = _recorded_aps(monkeypatch, cfg, pipeline.init_states(cfg, np.stack([s.gt_poses[0] for s in seqs])), stacked)
    assert aps.shape == (FLEET_EAGER_TICKS, ROBOTS, 6, 6)
    for i, ap in enumerate(aps):
        got = teigh.eigh6(ap)
        _assert_bits(got, teigh.plain_eigh6(ap), f"tick {i}: ")
        for b in range(ROBOTS):
            _assert_bits(teigh.eigh6(ap[b]), (got[0][b], got[1][b]), f"tick {i}, robot {b} alone: ")


@pytest.mark.gpu
@pytest.mark.parametrize("fleet", [False, True], ids=["spot", "fleet"])
def test_captured_replays_with_the_kernel_match_no_kernels(cuda_device, fleet):
    """A 240-sweep Spot pass, alone (`make_scan_replay`) and as a 4-robot
    fleet (`make_batched_replay`), captured with the kernels and inside
    `no_kernels()`: the same poses bit for bit, one B8 launch a sweep or
    tick and none in the plain replay. The fleet's outputs are all
    bit-equal (the plain version's batched products); alone, the
    covariance and condition number within 1 ulp, the rest bit-equal."""
    from locus_tpu_torch.metrics import RateReport

    cfg = _spot_cfg()
    robots = ROBOTS if fleet else 1
    seqs = [make_tunnel_sequence(num_scans=SWEEPS, azimuth_steps=1800, step=0.16, seed=b) for b in range(robots)]
    packed = [runner.pack_sequence(s, cfg) for s in seqs]
    init = np.stack([s.gt_poses[0] for s in seqs])

    def replay():
        outs, report = [], RateReport()
        if fleet:
            runner.make_batched_replay(cfg)(pipeline.init_states(cfg, init), runner.stack_packed(packed),
                                            report=report, outputs=outs)
        else:
            runner.make_scan_replay(cfg)(pipeline.init_state(cfg, initial_pose=torch.as_tensor(init[0])), packed[0],
                                         report=report, outputs=outs)
        assert report.captured
        return [[x.cpu() for x in o] for o in outs], kernels.read_launches()["eigh6"]

    kernels.reset_launches()
    got, launches = replay()
    assert launches == SWEEPS
    kernels.reset_launches()
    with dispatch.no_kernels():
        want, plain_launches = replay()
    assert plain_launches == 0
    fields = pipeline.StepOutput._fields
    worst = 0
    for i, (a, b) in enumerate(zip(got, want)):
        for name, x, y in zip(fields, a, b):
            if not fleet and name in ("covariance", "condition_number"):
                worst = max(worst, int(_ulps(x, y).max()))
                assert worst <= 1, f"sweep {i}: {name}"
            else:
                assert torch.equal(x, y), f"sweep {i}: {name}"
    print("ulps of the covariance and condition number against no_kernels():", worst)

"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points run on the CPU only when asked, and chip_smoke.py refuses to
run without a card or outside the checkout. Exact checks."""
import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (imported by every test_torch_* file; unused here)
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "locus_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_no_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "locus_tpu"), f"{path} imports {name}"


def test_port_names_no_jax():
    """No line of the port names JAX or a module of the JAX package."""
    pattern = re.compile(r"\bjax\b|\blocus_tpu\.[a-z]")
    for path in PORT.rglob("*.py"):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not pattern.search(line), f"{path}:{n}: {line}"


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['locus_tpu'] = None\n"
        f"for m in {modules!r}:\n"
        "    __import__(m)\n"
        "import locus_tpu_torch.runner\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    from locus_tpu_torch import pipeline, runner
    from locus_tpu_torch.config import LocusConfig
    from locus_tpu_torch.io.dataset import make_tunnel_sequence

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seq = make_tunnel_sequence(num_scans=1, azimuth_steps=64, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.run_sequence(seq, LocusConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.init_state(LocusConfig())
    state = pipeline.init_state(LocusConfig(), device="cpu")
    assert state.map.nn_aug.device.type == "cpu"


def test_serving_entry_points_need_a_card_unless_asked(monkeypatch):
    """LiveSession, the pose-graph backend and its solver, and the replay
    with a backend run on the card unless given device="cpu"."""
    import numpy as np

    from locus_tpu_torch import runner
    from locus_tpu_torch.backend import PoseGraphBackend
    from locus_tpu_torch.config import LocusConfig
    from locus_tpu_torch.io.dataset import make_tunnel_sequence
    from locus_tpu_torch.live import LiveSession
    from locus_tpu_torch.parallel import posegraph

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eye = np.eye(4, dtype=np.float32)[None]
    for make in (
        lambda: LiveSession(cfg=LocusConfig()),
        lambda: PoseGraphBackend(),
        lambda: posegraph.make_graph(eye, [0], [0], eye),
        lambda: runner.run_sequence(make_tunnel_sequence(num_scans=1, azimuth_steps=64, seed=0), LocusConfig(),
                                    backend=PoseGraphBackend(device="cpu")),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert LiveSession(cfg=LocusConfig(), device="cpu").state.map.nn_aug.device.type == "cpu"
    assert posegraph.make_graph(eye, [0], [0], eye, device="cpu").poses.device.type == "cpu"


def test_chip_smoke_refuses_without_a_card_or_checkout(tmp_path):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

"""The port stands alone and runs on the card unless told otherwise:
no module of battlezips_halo2_tpu_torch, nor chip_smoke.py,
tools/torch_profile_shot.py or tools/torch_exp_step_t.py, imports JAX or
the JAX package; entry points refuse the CPU unless ``device="cpu"``;
chip_smoke.py fails without a card and outside a checkout."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "battlezips_halo2_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "battlezips_halo2_tpu")


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py"))
    + [ROOT / "chip_smoke.py", ROOT / "tools" / "torch_profile_shot.py", ROOT / "tools" / "torch_exp_step_t.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from battlezips_halo2_tpu_torch import api, convert
    from battlezips_halo2_tpu_torch.ops.cuda import resolve_device
    from battlezips_halo2_tpu_torch.pcs.ipa import Params
    from battlezips_halo2_tpu_torch.utils import BinaryValue

    for call in (
        lambda: resolve_device(None),
        lambda: Params.new(2),
        lambda: convert.params_from_reference(Params.new(2, device="cpu")),
        lambda: api.prove_shot(BinaryValue(1), 1, (0, 0), False),
        lambda: api.verify_shot(api.ShotProof((0, 0), 0, 0, b"")),
        lambda: api.board_keys(),
        lambda: api.prove_board([None] * 5, 1),
        lambda: api.verify_board(api.BoardProof((0, 0), b"")),
        lambda: api.prove_session([[None] * 5], shots_per_game=1, trapdoors=[1]),
        lambda: api.verify_session(api.GameSession([api.BoardProof((0, 0), b"")], [])),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert Params.new(2, device="cpu").device == torch.device("cpu")


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=300
    )


def test_chip_smoke_fails_without_card_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run_smoke(ROOT)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_launch_counts_exact_across_threads():
    """ops/cuda.py counts under a lock: threads proving at once
    (api.prove_session(workers > 1)) lose no launch."""
    import threading

    from battlezips_halo2_tpu_torch.ops import cuda

    per_thread, n_threads = 20_000, 16
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        cuda.reset_launches()
        threads = [
            threading.Thread(target=lambda: [cuda.count("K1") for _ in range(per_thread)]) for _ in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert cuda.launches["K1"] == per_thread * n_threads
    finally:
        sys.setswitchinterval(interval)
        cuda.reset_launches()

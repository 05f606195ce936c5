"""Boundaries of vargp_tpu_torch: it imports neither JAX nor the JAX
package, ``chip_smoke.py`` neither, the script refuses to run without a
card, and the kernel build refuses to run without ``nvcc``."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vargp_tpu_torch
for m in pkgutil.walk_packages(vargp_tpu_torch.__path__, "vargp_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n.startswith("jaxlib")
             or n == "vargp_tpu" or n.startswith("vargp_tpu."))
print(len([n for n in sys.modules if n.startswith("vargp_tpu_torch")]), bad)
"""


def test_package_imports_no_jax_and_nothing_of_the_jax_package(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
    )
    assert res.returncode == 0, res.stderr
    n_modules, bad = res.stdout.split(maxsplit=1)
    assert int(n_modules) >= 20
    assert bad.strip() == "[]"


@pytest.mark.parametrize("path", [
    "chip_smoke.py", *sorted(str(p.relative_to(REPO)) for p in (REPO / "vargp_tpu_torch").rglob("*.py")),
])
def test_sources_name_no_jax_import(path):
    src = (REPO / path).read_text()
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|vargp_tpu|conftest)\b(?!_torch)", re.M)
    assert not pat.findall(src), path


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card: the script exits non-zero quickly and prints no result.
    The same holds for the script alone in a directory, without the port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run in full")
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_build_without_nvcc_raises_and_writes_nothing(tmp_path, monkeypatch):
    from vargp_tpu_torch.ops.cuda import build

    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "_build").exists()


def test_build_hashes_every_source():
    from vargp_tpu_torch.ops.cuda import build

    names = {p.name for p in build.sources()}
    assert names == {"sym_gram.cu", "sym_gram_tri.cu", "cross_gram.cu", "diag_chol.cu",
                     "rbf_gram.cu", "diag_chol_chunked.cu", "chol.cu", "chol_inv.cu", "tri_mm.cu",
                     "marginal_moments.cu"}
    assert build.library_path().parent.parent == build.BUILD_ROOT
    assert re.fullmatch(r"[0-9a-f]{16}", build.library_path().parent.name)


def test_tf32_is_off_after_import():
    import vargp_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False

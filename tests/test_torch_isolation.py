"""The port stands alone: no module of ``repro_torch`` (nor chip_smoke.py,
nor the port's examples ``examples/torch_*.py``) imports jax or anything
of the reference package ``repro``."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
EXAMPLES = ["torch_quickstart", "torch_audio_frontend",
            "torch_distributed_fft", "torch_serve_batched", "torch_train_lm"]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.kernels.ops" in mods and "repro_torch.core.plan" in mods
    assert {"repro_torch.dist.pencil", "repro_torch.dist.pipeline",
            "repro_torch.dist.local", "repro_torch.tt.trace",
            "repro_torch.tt.report", "repro_torch.models.model",
            "repro_torch.models.layers", "repro_torch.serve.engine",
            "repro_torch.configs", "repro_torch.analysis.opcount",
            "repro_torch.analysis.reanalyze", "repro_torch.launch.dryrun",
            "repro_torch.launch.fft_dryrun",
            "repro_torch.launch.pp_variant"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_examples_import_without_jax_or_repro():
    assert sorted(f.stem for f in (ROOT / "examples").glob("torch_*.py")) \
        == sorted(EXAMPLES)
    code = ("import importlib, sys\n"
            f"sys.path.insert(0, {str(ROOT / 'examples')!r})\n"
            f"for m in {EXAMPLES!r}: importlib.import_module(m).main\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_no_jax_or_repro_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        [ROOT / "examples" / f"{m}.py" for m in EXAMPLES]
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        assert not _IMPORT.search(text), f
        assert "import_module(\"jax" not in text and \
            "import_module('jax" not in text, f

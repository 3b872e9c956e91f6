"""The PyTorch port stands alone: no file of it, nor chip_smoke.py, imports
JAX, the JAX package or ``ml_dtypes`` (which the card's machine lacks);
importing it loads none of them; and its entry points refuse to run on the
CPU unless asked to."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)|"
    r"from\s+repro(\.|\s)(?!_torch)|import\s+ml_dtypes\b|from\s+ml_dtypes\b)",
    re.M)


COST_MODEL = ("alphabeta", "collectives", "hardware", "compute_model", "workload",
              "optable", "fabric", "topology", "overlap", "specdec", "placement")
# the search and selection over the cost model
SEARCH = ("tco", "optimizer", "sweep", "api", "availability", "pareto", "future",
          "traffic")
EXAMPLES = ("quickstart_torch.py", "serve_moe_torch.py", "train_lm_torch.py")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    text = path.read_text()
    assert not FORBIDDEN.findall(text), f"{path} imports jax, repro or ml_dtypes"


def test_every_port_module_is_checked():
    """The scan covers every module of the port, the RWKV layer, the
    configs of the dense, RWKV, ViT-patch and encoder-decoder models, the
    training loop and checkpoints, the multi-device Dist, specs and
    launchers, the dry run, its roofline and collective counter, and the
    cost model's copies, its search and grid engine, and the port's
    examples among them."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("models/layers/rwkv.py", "models/layers/attention.py",
                "configs/deepseek_67b.py", "configs/minitron_8b.py",
                "configs/rwkv6_1_6b.py", "configs/internvl2_76b.py",
                "configs/seamless_m4t_medium.py", "serving/engine.py", "convert.py",
                "training/train_loop.py", "training/checkpoint.py",
                "sharding/dist.py", "sharding/specs.py", "launch/mesh.py",
                "launch/steps.py", "launch/serve.py", "launch/dryrun.py",
                "sharding/counting.py", "analysis/roofline.py", "core/sweep_torch.py",
                "core/scenario.py", "faults.py",
                *(f"core/{m}.py" for m in COST_MODEL + SEARCH)):
        assert f"src/repro_torch/{mod}" in names, mod
    for ex in EXAMPLES:
        assert f"examples/{ex}" in names, ex
    assert "chip_smoke.py" in names


def test_forbidden_pattern_catches_imports():
    for line in ("import jax", "from jax import numpy", "import repro",
                 "from repro.configs import get_arch", "  import jax.numpy as jnp",
                 "import ml_dtypes", "from ml_dtypes import bfloat16"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.configs import x",
                 "import torch"):
        assert not FORBIDDEN.search(line), line


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch, repro_torch.convert, repro_torch.kernels.ops\n"
            "import repro_torch.serving.engine, repro_torch.models.model\n"
            "import repro_torch.kernels.build\n"
            "import repro_torch.models.layers.rwkv, repro_torch.serving.specdec\n"
            "import repro_torch.training.fault_tolerance, repro_torch.training.compression\n"
            "import repro_torch.launch.serve, repro_torch.launch.steps\n"
            "import repro_torch.launch.mesh, repro_torch.sharding.specs\n"
            "import repro_torch.launch.dryrun, repro_torch.analysis.roofline\n"
            "import repro_torch.core.sweep_torch, repro_torch.core.topology\n"
            "import repro_torch.core.optable, repro_torch.core.scenario\n"
            "import repro_torch.faults, repro_torch.core\n"
            "import repro_torch.core.traffic, repro_torch.core.pareto\n"
            "import repro_torch.core.future, repro_torch.core.availability\n"
            "from repro_torch.configs import ARCHS\n"
            "assert len(ARCHS) == 11\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'ml_dtypes' not in sys.modules, 'ml_dtypes imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_default_device_raises_without_a_card(monkeypatch):
    """With no CUDA device, the default-device entry points raise instead of
    running on the CPU."""
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(get_arch("olmoe-1b-7b"), dtype="float32")
    params = M.init_model(cfg, device="cpu")
    for call in (lambda: Engine(cfg, params), lambda: M.init_model(cfg),
                 lambda: M.init_cache(cfg, batch=1, seq=4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_converter_defaults_to_the_card(monkeypatch):
    """The weight converter, like every other entry point, puts tensors on
    the card by default, so without one it raises instead of using the CPU."""
    import numpy as np

    from repro_torch import convert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.ones((2, 3), np.float32)}
    for call in (lambda: convert.to_torch(tree["w"]),
                 lambda: convert.tree_map(convert.to_torch, tree)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert convert.to_torch(tree["w"], "cpu").device.type == "cpu"

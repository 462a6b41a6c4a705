"""The port stands alone: ``paddle_tpu_torch`` imports with JAX unavailable,
no module of it (nor ``chip_smoke.py``) imports ``jax`` or ``paddle_tpu``,
and its entry points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = (
    "paddle_tpu_torch",
    "paddle_tpu_torch.metrics",
    "paddle_tpu_torch.core",
    "paddle_tpu_torch.telemetry",
    "paddle_tpu_torch.ops.attention",
    "paddle_tpu_torch.ops.nn",
    "paddle_tpu_torch.ops.kernels.flash_attention",
    "paddle_tpu_torch.ops.kernels.paged_attention",
    "paddle_tpu_torch.models.transformer",
    "paddle_tpu_torch.serving",
    "paddle_tpu_torch.serving.engine",
    "paddle_tpu_torch.serving.export",
    "paddle_tpu_torch.serving.__main__",
    "paddle_tpu_torch.config.parse_state",
    "paddle_tpu_torch.config.topology",
    "paddle_tpu_torch.core.initializer",
    "paddle_tpu_torch.core.parameters",
    "paddle_tpu_torch.layers.base",
    "paddle_tpu_torch.layers.attr",
    "paddle_tpu_torch.layers.activation",
    "paddle_tpu_torch.layers.pooling",
    "paddle_tpu_torch.layers.data_type",
    "paddle_tpu_torch.layers.api",
    "paddle_tpu_torch.ops.activations",
    "paddle_tpu_torch.ops.loss",
    "paddle_tpu_torch.ops.math",
    "paddle_tpu_torch.ops.kernels.brgemm",
    "paddle_tpu_torch.ops.kernels.conv",
    "paddle_tpu_torch.models.image",
    "paddle_tpu_torch.optimizer",
    "paddle_tpu_torch.trainer",
    "paddle_tpu_torch.trainer.step",
    "paddle_tpu_torch.trainer.event",
    "paddle_tpu_torch.reader",
    "paddle_tpu_torch.reader.decorator",
    "paddle_tpu_torch.reader.feeder",
)


def test_imports_with_jax_unavailable():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['paddle_tpu'] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "paddle_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_paddle_tpu_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_entry_points_refuse_the_cpu_unless_asked():
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: cuda:0 is the right answer")
    with pytest.raises(EnforceError, match="no CUDA card"):
        resolve_device(None)
    with pytest.raises(EnforceError, match="no CUDA card"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = T.TransformerConfig(vocab_size=16, num_layers=1, num_heads=2,
                              embed_dim=16, mlp_dim=32, max_seq_len=32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    scfg = ServingConfig(max_slots=1, page_size=4, num_pages=8,
                         max_prompt_len=8, max_new_tokens=4)
    with pytest.raises(EnforceError, match="no CUDA card"):
        ServingEngine(cfg, params, scfg)
    ServingEngine(cfg, params, scfg, device="cpu")  # asked for: runs

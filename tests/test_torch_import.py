"""The port stands alone: ``repro_torch`` imports with jax blocked, and no
file of it (nor ``chip_smoke.py``) imports jax or the reference package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.interop\n"
        "import repro_torch.core.experiment, repro_torch.core.metrics\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.serving\n"
        "import repro_torch.serving.engine, repro_torch.serving.warmpool\n"
        "import repro_torch.models.transformer\n"
        "import repro_torch.kernels.decode_attention\n"
        "import repro_torch.kernels.histogram\n"
        "import repro_torch.forecast, repro_torch.forecast.arima_batched\n"
        "import repro_torch.forecast.forecaster, repro_torch.forecast.replay\n"
        "import repro_torch.serving.apptable, repro_torch.serving.cluster_sim\n"
        "import repro_torch.serving.cluster_vector\n"
        "import repro_torch.runtime, repro_torch.runtime.straggler\n"
        "import repro_torch.runtime.fault_tolerance\n"
        "import repro_torch.training.optimizer, repro_torch.training.data\n"
        "import repro_torch.training.checkpoint\n"
        "import repro_torch.training.train_loop\n"
        "import repro_torch.launch.steps, repro_torch.launch.train\n"
        "import repro_torch.launch.serve, repro_torch.serving.scheduler\n"
        "import repro_torch.core.dataset_export\n"
        "import repro_torch.core.welford, repro_torch.core.arima\n"
        "import repro_torch.distributed.scaleout\n"
        "import repro_torch.examples.quickstart\n"
        "import repro_torch.examples.policy_explorer\n"
        "import repro_torch.examples.serve_serverless\n"
        "import repro_torch.examples.train_smollm\n"
        "import repro_torch.examples.export_dataset\n"
        "assert not [m for m in sys.modules if m.startswith('jax')"
        " and sys.modules[m] is not None]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_resolve_device(monkeypatch):
    from repro_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")


def test_serve_engine_asked_for_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.serving import Registry, ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ServeEngine(Registry())
    with pytest.raises(RuntimeError):
        ServeEngine(Registry(), device="cuda")


def test_run_cluster_defaults_to_cuda(monkeypatch):
    """The fleet engines run phase B (and the oracle's forecasters) on the
    card unless the caller asks for the CPU; without a card that raises,
    for every engine and through the experiment front door."""
    from repro_torch.core.experiment import FixedSpec, HybridSpec, run
    from repro_torch.core.workload_spec import azure_like
    from repro_torch.serving import ClusterSpec, run_cluster, sweep_cluster
    spec = azure_like(8, days=0.1, seed=1, max_events=4)
    cl = ClusterSpec(n_workers=2, hbm_budget_bytes=float("inf"))
    assert run_cluster(spec, HybridSpec(), cl, device="cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ("auto", "vector", "scalar"):
        with pytest.raises(RuntimeError, match="is_available"):
            run_cluster(spec, FixedSpec(), cl, engine=engine)
    with pytest.raises(RuntimeError, match="is_available"):
        run(spec, HybridSpec(), cluster=cl)
    with pytest.raises(RuntimeError, match="is_available"):
        sweep_cluster(spec, [FixedSpec()], [cl])


@pytest.mark.parametrize("arch,entry", [
    ("mamba2-2.7b", "init"), ("mamba2-2.7b", "init_state"),
    ("recurrentgemma-2b", "init"), ("recurrentgemma-2b", "init_cache"),
    ("qwen2-7b", "init"), ("qwen2-7b", "make_cache")])
def test_model_entry_points_default_to_cuda(monkeypatch, arch, entry):
    """Weights and decode state are made on the card unless the caller
    asks for the CPU; without a card that raises."""
    from repro_torch import configs
    from repro_torch.models import layers, mamba2, rglru, transformer
    cfg = configs.reduced(configs.get(arch))
    mod = {"ssm": mamba2, "hybrid": rglru, "dense": transformer}[cfg.family]
    if entry == "init":
        call = lambda **kw: mod.init(cfg, 0, **kw)
    elif entry == "make_cache":
        call = lambda **kw: layers.make_cache(cfg, 1, 8, 2, torch.float32,
                                              **kw)
    else:
        call = lambda **kw: getattr(mod, entry)(cfg, 1, torch.float32, **kw)
    assert call(device="cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        call()

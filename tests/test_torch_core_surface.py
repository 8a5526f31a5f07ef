"""``repro_torch.core`` re-exports what the reference's ``repro.core``
exports, so ``from repro_torch.core import run`` works as ``from
repro.core import run`` does."""
import inspect
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch.core as port_core

REPO = Path(__file__).resolve().parents[1]
NOT_PORTED = set()
# every name of the reference's policy_math is ported (the factored sweep
# was the last)
POLICY_MATH_NOT_PORTED = set()


@pytest.fixture(scope="module")
def ref_core():
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        import repro.core
        yield repro.core


def test_all_is_the_reference_all_minus_the_unported_names(ref_core):
    want = [n for n in ref_core.__all__ if n not in NOT_PORTED]
    assert list(port_core.__all__) == want
    assert NOT_PORTED <= set(ref_core.__all__)


@pytest.mark.parametrize("name", list(port_core.__all__))
def test_each_exported_name_resolves_to_the_port(ref_core, name):
    """A module of the port, a class or function of the port's of the same
    name, or a value of the reference's type."""
    obj = getattr(port_core, name)
    ref_obj = getattr(ref_core, name)
    if inspect.ismodule(obj):
        assert obj.__name__ == f"repro_torch.core.{name}"
    elif inspect.isclass(obj) or inspect.isfunction(obj):
        assert obj.__name__ == ref_obj.__name__ == name
        assert obj.__module__.startswith("repro_torch.core.")
    else:
        assert type(obj) is type(ref_obj)


@pytest.mark.parametrize("module", [
    "core.experiment", "core.policy", "core.policy_math", "forecast",
    "forecast.forecaster", "forecast.replay", "core.welford",
    "core.histogram", "core.workload_spec"])
def test_module_surface_is_the_reference_surface(ref_core, module):
    """The modules this package shares with the reference export the
    reference's names (SpesSpec, SpesConfig, SpesPolicy and the
    forecasting subsystem among them), the port's own additions after
    them."""
    import importlib
    mine = importlib.import_module(f"repro_torch.{module}")
    theirs = importlib.import_module(f"repro.{module}")
    want = list(theirs.__all__)
    if module == "core.policy_math":
        want = [n for n in want if n not in POLICY_MATH_NOT_PORTED]
    assert list(mine.__all__)[:len(want)] == want
    for name in want:
        obj = getattr(mine, name)
        if inspect.isclass(obj) or inspect.isfunction(obj):
            assert obj.__module__.startswith("repro_torch."), name


def test_fit_surface_is_the_reference_surface(ref_core):
    import repro.forecast.arima_batched as theirs
    import repro_torch.forecast.arima_batched as mine
    assert list(mine.__all__)[:len(theirs.__all__)] == list(theirs.__all__)


def test_front_door_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.core import run, HybridSpec, WorkloadSpec\n"
            "print(run.__module__, HybridSpec.__module__, "
            "WorkloadSpec.__module__)\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["repro_torch.core.experiment",
                                   "repro_torch.core.experiment",
                                   "repro_torch.core.workload_spec"]

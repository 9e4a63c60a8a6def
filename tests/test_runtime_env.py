"""What the package needs from its installation and environment.

- `import hank_tpu` and every shipped model load without PyYAML;
- the compile cache follows JAX_COMPILATION_CACHE_DIR, else a fixed path
  inside the checkout; the artifact root follows HANK_TPU_CACHE, else
  `.hank_cache/` inside the checkout;
- the device checks refuse to fall back: `chip_smoke.py` exits non-zero with
  no result line on a CPU-only process, and `dryrun_multichip` raises when
  the process has fewer devices than asked for.
"""

import json
import os
import subprocess
import sys

import pytest

from hank_tpu.models import SHIPPED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_YAML = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "yaml" or name.startswith("yaml."):
            raise ModuleNotFoundError("No module named 'yaml' (blocked)")
sys.meta_path.insert(0, _Block())
import hank_tpu
from hank_tpu.models import SHIPPED, load_model
print("IMPORTED", "yaml" in sys.modules)
for name in sorted(SHIPPED):
    m = load_model(name)
    print("LOADED", name, m.compspec.T, len(m.equations))
"""


def _run(code: str, env_extra: dict | None = None, args=()) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO})
    for k, v in (env_extra or {}).items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    cmd = [sys.executable] + (["-c", code] if code else list(args))
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)


@pytest.fixture(scope="module")
def no_yaml_run():
    return _run(_NO_YAML)


def test_import_without_yaml(no_yaml_run):
    assert no_yaml_run.returncode == 0, no_yaml_run.stderr[-2000:]
    assert "IMPORTED False" in no_yaml_run.stdout


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_load_model_without_yaml(no_yaml_run, name):
    assert no_yaml_run.returncode == 0, no_yaml_run.stderr[-2000:]
    assert any(line.startswith(f"LOADED {name} ")
               for line in no_yaml_run.stdout.splitlines())


_CACHE_PROBE = """
import os, jax
import hank_tpu
print(json.dumps({"dir": jax.config.jax_compilation_cache_dir,
                  "repo_dir": hank_tpu.REPO_CACHE_DIR}))
if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.block_until_ready(jax.jit(lambda x: x * 3.0 + 1.0)(2.0))
"""


def test_compile_cache_follows_env(tmp_path):
    target = tmp_path / "xla_cache"
    r = _run("import json\n" + _CACHE_PROBE,
             {"JAX_COMPILATION_CACHE_DIR": str(target)})
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[0])
    assert got["dir"] == str(target)
    assert target.is_dir() and any(target.iterdir())   # written there


def test_compile_cache_defaults_inside_checkout():
    r = _run("import json\n" + _CACHE_PROBE,
             {"JAX_COMPILATION_CACHE_DIR": None})
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[0])
    assert got["dir"] == got["repo_dir"] == os.path.join(REPO, ".jax_cache")


def test_artifact_root_follows_env(monkeypatch, tmp_path):
    from hank_tpu.utils.checkpoint import cache_root, default_cache_dir

    monkeypatch.setenv("HANK_TPU_CACHE", str(tmp_path))
    assert cache_root() == str(tmp_path)
    assert default_cache_dir() == os.path.join(str(tmp_path), "artifacts")


def test_artifact_root_defaults_inside_checkout(monkeypatch):
    from hank_tpu.utils.checkpoint import cache_root

    monkeypatch.delenv("HANK_TPU_CACHE", raising=False)
    assert cache_root() == os.path.join(REPO, ".hank_cache")


def test_chip_smoke_device_check_raises_on_cpu():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.device_check()


@pytest.mark.parametrize("args", [[], ["--two-asset"], ["--four-cards"]],
                         ids=["default", "two_asset", "four_cards"])
def test_chip_smoke_fails_without_gpu(args):
    r = _run("", args=[os.path.join(REPO, "chip_smoke.py"), *args])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_dryrun_multichip_refuses_missing_devices():
    import jax

    from __graft_entry__ import dryrun_multichip

    with pytest.raises(RuntimeError, match="needs"):
        dryrun_multichip(len(jax.devices()) + 1)

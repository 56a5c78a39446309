"""Process setup: the compile-cache directory, the kernel-or-plain choice,
and the bring-up smoke's refusal to run without a GPU."""

import glob
import os
import subprocess
import sys

import pytest

from slam1_tpu.ops import dispatch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Compiles one uniquely named program in a fresh process; its cache
# entry's file name starts with jit_<name>.
_PROBE = """
import jax, jax.numpy as jnp
import slam1_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
def {name}(x):
    return jnp.sin(x) * 3
jax.jit({name})(jnp.ones(3)).block_until_ready()
"""


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_directory(tmp_path, env_set):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    default = os.path.join(_REPO, ".jax_cache")
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    name = f"probe_{os.getpid()}_{int(env_set)}_{tmp_path.name}".replace(
        "-", "_")
    subprocess.run([sys.executable, "-c", _PROBE.format(name=name)],
                   env=env, cwd=str(tmp_path), capture_output=True,
                   timeout=120, check=True)

    def entries(d):
        return glob.glob(os.path.join(str(d), f"jit_{name}*"))

    try:
        if env_set:
            assert entries(tmp_path / "cache"), "not in the env directory"
            assert not entries(default), "cached outside the env directory"
        else:
            assert entries(default), "not in <checkout>/.jax_cache"
    finally:
        for f in entries(default):
            os.remove(f)


@pytest.mark.parametrize("platform,kernel", [("gpu", True), ("cpu", False)])
def test_kernel_or_plain_by_platform(platform, kernel):
    assert dispatch.kernel_for(platform) is kernel


def test_unknown_platform_raises():
    with pytest.raises(RuntimeError, match="rocm"):
        dispatch.kernel_for("rocm")


@pytest.mark.parametrize("argv", [[], ["--cards", "4"]])
def test_chip_smoke_refuses_cpu(argv, capsys):
    sys.path.insert(0, _REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(_REPO)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    # Only the device line: no phase ran and no result was printed.
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].startswith("device: platform=cpu")

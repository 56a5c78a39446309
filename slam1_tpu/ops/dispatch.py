"""Backend dispatch: the Pallas GPU kernels on a GPU, plain `jnp` on the CPU.

Decided at trace time from the default backend (the backend cannot
change under a live jit cache). A platform with neither path is an
error, never a silent fallback.
"""

from __future__ import annotations

import jax


def kernel_for(platform: str) -> bool:
    """True for the kernel path on `platform`, False for plain `jnp`."""
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain path for platform {platform!r}")


def use_kernels() -> bool:
    """The choice for the default backend of this process."""
    return kernel_for(jax.default_backend())

"""Process-level runtime setup for the framework.

Two things happen at import:

  1. Matmul precision is pinned to "highest". The DEFAULT precision of
     an f32 contraction is TF32 on the GPU (and bf16 passes on some XLA
     CPU builds) — fine for neural nets, fatal for chained SE(3)
     geometry (a 3x3 @ 3x3 at bf16 loses ~3e-2 absolute). Hot large
     contractions that tolerate it (descriptor matmuls, blurs, one-hot
     selections) opt back down explicitly via
     `precision=jax.lax.Precision.DEFAULT` or int8/bf16 operands.

  2. A persistent compilation cache is enabled, so test re-runs and CLI
     restarts skip compilation: in JAX_COMPILATION_CACHE_DIR when that
     is set (JAX reads it itself), otherwise in <checkout>/.jax_cache.
"""

from __future__ import annotations

import os

import jax

jax.config.update("jax_default_matmul_precision", "highest")

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

"""What a run must not inherit or load.

The environment: the port reads ADAPTIGRAPH_GNN_AGG and
ADAPTIGRAPH_GNN_DTYPE to change which aggregation mode and which
precision run, so a run refuses to start when either is set. Caches:
Triton's and torch's extension builds go to fixed directories inside the
checkout. The modules: once the window has closed, no loaded module may
have the top-level name of JAX, of its libraries or of the JAX package
that the port was made from, compared whole (the port's own name begins
with the JAX package's).
"""

from __future__ import annotations

import os
import sys

REFUSED_ENV = ("ADAPTIGRAPH_GNN_AGG", "ADAPTIGRAPH_GNN_DTYPE")
REFUSED_MODULES = ("jax", "jaxlib", "flax", "adaptigraph_tpu",
                   "__graft_entry__", "bench", "chip_smoke")


def refused_env(environ=None) -> list:
    """The refused variables set in `environ` (os.environ by default)."""
    environ = os.environ if environ is None else environ
    return [k for k in REFUSED_ENV if k in environ]


def set_cache_dirs(root: str) -> dict:
    """Point the build caches at fixed directories under root/_cache."""
    dirs = {"TRITON_CACHE_DIR": os.path.join(root, "_cache", "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(root, "_cache",
                                                 "torch_extensions")}
    for k, v in dirs.items():
        os.environ[k] = v
    return dirs


def refused_modules(modules=None) -> list:
    """Loaded module names whose top-level name is refused."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules
                  if m.split(".", 1)[0] in REFUSED_MODULES)

"""Batched tensor environments: Pendulum, and DM-Control through a host pool.

Importing this package imports neither mujoco nor dm_control: the
DM-Control env (``dmc_host.DMCHostEnv``) and the native pool binding
(``native_pool``) load them when an env is built.
"""

import os

# dm_control chooses its GL backend once, when it is first imported, and
# any entry point may be the first to import it (an env's construction, the
# native pool's asset lookup, a test).  So a backend is pinned here, before
# a pixels env renders, unless the user chose one: headless EGL where libEGL
# exists; else glfw (imports without a display and renders only if one
# appears); else no renderer.  State-observation envs never render, so they
# work with any of the three.


def _default_mujoco_gl() -> str:
    import ctypes.util

    if ctypes.util.find_library("EGL"):
        return "egl"
    try:
        import glfw  # noqa: F401  (a bundled library find_library cannot see)

        return "glfw"
    except Exception:
        return "disabled"


os.environ.setdefault("MUJOCO_GL", _default_mujoco_gl())

from r2d2dpg_torch.envs.core import EnvSpec, Environment, TimeStep  # noqa: E402
from r2d2dpg_torch.envs.dmc_host import DMCHostEnv  # noqa: E402
from r2d2dpg_torch.envs.pendulum import Pendulum, PendulumState  # noqa: E402

__all__ = [
    "DMCHostEnv",
    "EnvSpec",
    "Environment",
    "Pendulum",
    "PendulumState",
    "TimeStep",
]

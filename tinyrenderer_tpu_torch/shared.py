"""The reference package's JAX-free modules that the port shares.

Configuration, scene description, asset loading and the image comparator
are plain numpy in ``tinyrenderer_tpu`` and are imported, never copied.
This module is the one place the port names them; importing it leaves
``jax`` out of ``sys.modules`` (tests/test_torch_import.py).
"""

from tinyrenderer_tpu import config  # noqa: F401
from tinyrenderer_tpu.assets import hdr, mesh, textures  # noqa: F401
from tinyrenderer_tpu.config import RenderConfig  # noqa: F401
from tinyrenderer_tpu.scene import components, demo, level_io, lights  # noqa: F401
from tinyrenderer_tpu.scene.camera import Camera  # noqa: F401
from tinyrenderer_tpu.scene.world import World  # noqa: F401
from tinyrenderer_tpu.utils import verify  # noqa: F401

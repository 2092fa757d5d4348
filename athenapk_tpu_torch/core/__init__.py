from .indices import *  # noqa: F401,F403
from .mesh import Mesh  # noqa: F401

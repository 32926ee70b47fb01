from . import mesh

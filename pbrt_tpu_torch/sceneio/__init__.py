""".pbrt scene files to a RenderSetup (port of pbrt_tpu/sceneio/)."""
from .api import RenderSetup
from .parser import parse_pbrt_file, parse_pbrt_string

__all__ = ["parse_pbrt_file", "parse_pbrt_string", "RenderSetup"]

"""python -m stereovision_tpu_torch — CLI entry (reference:
stereo_vision/__main__.py)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())

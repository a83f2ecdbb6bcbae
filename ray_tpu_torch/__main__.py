"""`python -m ray_tpu_torch` CLI entry (reference: the `ray` console script)."""
import sys

from .scripts.cli import main

sys.exit(main())

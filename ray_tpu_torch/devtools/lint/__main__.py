"""``python -m ray_tpu_torch.devtools.lint`` — see cli.py."""

import sys

from .cli import main

sys.exit(main())

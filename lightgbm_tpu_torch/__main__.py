"""``python -m lightgbm_tpu_torch config=train.conf`` -- the CLI entry point
(reference: src/main.cpp)."""

import sys

from .cli import main

sys.exit(main())

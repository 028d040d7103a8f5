"""``python -m dmf_tpu_torch <command>``: the command line (``cli.py``)."""

import sys

from .cli import main

sys.exit(main())

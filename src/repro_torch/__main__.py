"""``python -m repro_torch`` — the port's command line (``repro_torch.api.cli``)."""

import sys

from repro_torch.api.cli import main

if __name__ == "__main__":
    sys.exit(main())

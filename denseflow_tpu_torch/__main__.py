"""`python -m denseflow_tpu_torch <input> [flags]`: the denseflow CLI."""

import sys

from denseflow_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())

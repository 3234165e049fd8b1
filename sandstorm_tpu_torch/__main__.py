"""python -m sandstorm_tpu_torch: the command line of cli.py."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())

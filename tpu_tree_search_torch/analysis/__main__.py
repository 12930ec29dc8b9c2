"""``python -m tpu_tree_search_torch.analysis`` — the ``lint`` subcommand
without the rest of the CLI (stdlib only)."""

import sys

from . import lint_main

if __name__ == "__main__":
    sys.exit(lint_main())

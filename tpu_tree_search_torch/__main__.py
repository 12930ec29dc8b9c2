"""``python -m tpu_tree_search_torch pfsp --inst 14 --lb lb1 --ub 1 --tier device``
or ``python -m tpu_tree_search_torch nqueens --N 15 --tier device``."""

import sys

from .cli import main

sys.exit(main())

"""``python3 -m raybench``: one run of one cell (see ``raybench.run``)."""

import time

SETUP_T0 = time.perf_counter()   # set-up is timed from here

if __name__ == "__main__":
    import sys

    from raybench.run import main

    sys.exit(main(SETUP_T0))

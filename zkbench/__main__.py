import time

T_START = time.perf_counter()

import sys  # noqa: E402

from zkbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))

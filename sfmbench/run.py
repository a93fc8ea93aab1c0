"""sfmbench: one run of one cell of the benchmark of mpsfm_tpu_torch.

    python3 sfmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices. The
last line of standard output is the result (JSON); the numbers the check
compared, with their limits, are the last lines of standard error.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the build and kernel caches of the checkout, at fixed paths; no library may load JAX
os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / ".cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(HERE), str(HERE.parent)]  # the harness, and the checkout that holds the program

from sfmb.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))

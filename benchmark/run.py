"""Run one cell of the benchmark of vip_tpu_torch on the CUDA card:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The last line of standard output is the result as one JSON object; the
numbers compared with the plain reference are the last lines of standard
error. See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# the program's kernel caches at fixed paths inside the checkout: the
# port builds into vip_tpu_torch/_build/, PyTorch's runtime-compiled
# kernels go here
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(HERE, ".cache",
                                                       "torch_kernels")
os.makedirs(os.environ["PYTORCH_KERNEL_CACHE_PATH"], exist_ok=True)
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from yardstick.harness import BenchError, main  # noqa: E402

if __name__ == "__main__":
    try:
        main(sys.argv[1:], T_START)
    except BenchError as exc:
        print(f"benchmark: {exc}", file=sys.stderr, flush=True)
        sys.exit(2)

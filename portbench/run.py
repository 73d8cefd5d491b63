"""One run of one cell of the benchmark of the PyTorch/CUDA port (``ser_tpu_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA card(s) the cell asks for.
``BENCHMARK.json`` names the cells; each cell's configuration, traffic mix, entry
driver and metric readers are files under ``portbench/`` found by name. The last line
of standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and ``check`` last); the
last lines of standard error give each compared number beside its limit. Exits 2,
printing no result, without the cards; 3 if JAX, its libraries or the JAX package
were loaded.
"""

import sys
import time

STARTED = time.perf_counter()

from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], started=STARTED))

"""The readings that the limits of ``correct`` are set from, on the chip:

    python3 -m pombench.control --workload <cell> --seeds 1,2,3 --seconds <s>

runs the cell once for each seed in one process (the build and the imports
paid once), each run as ``pombench.run`` makes it with a window of
``--seconds``, and prints for each seed one JSON line: the program's
compared numbers (``program``) and those of the control (``control``), the
reference computed in the precision below the configuration's
(``check.CONTROL``: bfloat16 for float32) in the program's place.  The
benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from pombench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    a = ap.parse_args(argv)
    import torch
    from pombench.cells import resolve
    if not torch.cuda.is_available():
        print("pombench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = resolve(a.workload)
    for seed in (int(x) for x in a.seeds.split(",")):
        r = run.run_cell(cell, seed, a.seconds, False,
                         torch.device("cuda", 0), control=True)
        print(json.dumps({
            "workload": a.workload, "seed": seed, "correct": r["correct"],
            "program": {k: v[0] for k, v in r["checks"].items()},
            "control": r["control"], "limits": cell.limits,
            "program_fields": r["fields"],
            "control_fields": r["control_fields"],
            "metrics": {k: v["value"] for k, v in r["metrics"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

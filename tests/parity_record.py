"""Parity-artifact recording for the slow statistical tests.

When ``BSSM_PARITY_OUT`` is set (by ``benchmarks/parity_run.py``), each slow
parity test appends one JSON line with the quantities it measured and the
reference targets it asserted against, so a committed ``PARITY_r0N.json``
records the statistical health of the round without re-running the ~40-min
suite (reference anchors in BASELINE.md).
"""
import json
import os
import time


def record(test: str, measured: dict, targets: dict | None = None) -> None:
    path = os.environ.get("BSSM_PARITY_OUT")
    if not path:
        return
    row = {"test": test, "ts": round(time.time(), 1),
           "measured": {k: (float(v) if hasattr(v, "__float__") else v)
                        for k, v in measured.items()}}
    if targets:
        row["targets"] = targets
    with open(path, "a") as fh:
        fh.write(json.dumps(row) + "\n")

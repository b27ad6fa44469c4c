"""Run-result logging in the reference's text formats
(reference utils/write_run_result.py:6-22).

Counterpart of alpha_yolo_quant_tpu/utils/run_log.py, numpy logic unchanged;
both packages write the same bytes and read each other's files.
"""

from __future__ import annotations

import os
from datetime import datetime


def write_run_result(out_dir: str, m_ap: float, stage: int,
                     comments: str = "Default") -> str:
    now = datetime.now()
    stamp = (f"DATE: {now.day}.{now.month}.{now.year} "
             f"TIME: {now.hour}:{now.minute}:{now.second}\n")
    if stage == 4:
        path = os.path.join(out_dir, "results", "ORIG_MODEL_MAP.txt")
        with open(path, "w") as f:
            f.write(stamp)
            f.write(f"ORIG MODEL mAP(.50 - .95): {m_ap}\n")
    else:
        path = os.path.join(out_dir, "results", "runs_val", "results.txt")
        with open(path, "a") as f:
            f.write(stamp)
            f.write(f"Comments: {comments}\n")
            f.write(f"QUANT MODEL mAP(.50 - .95): {m_ap}\n")
            f.write("---------------\n\n")
    return path


def read_run_results(out_dir: str) -> list:
    """Parse results.txt back into (date, comment, mAP) tuples
    (reference utils/plot_run_results.py:8-28 reads the same file)."""
    path = os.path.join(out_dir, "results", "runs_val", "results.txt")
    runs = []
    if not os.path.exists(path):
        return runs
    cur = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("DATE:"):
                cur = {"date": line}
            elif line.startswith("Comments:"):
                cur["comment"] = line.split(": ", 1)[1]
            elif line.startswith("QUANT MODEL"):
                cur["map"] = float(line.rsplit(": ", 1)[1])
                runs.append(cur)
    return runs

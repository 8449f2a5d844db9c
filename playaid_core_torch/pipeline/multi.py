"""Multi-VOD batch runner.

Replaces the reference's shell fan-out of 7 background manuscript
processes (reference: multi_manuscript.sh:1-7) with an in-process
scheduler: the host-heavy stages (decode, stats, annotate, encode) of N
VODs run on a thread pool sized to the host, sharing one device context —
so TPU inference stages from different VODs interleave instead of
serializing behind separate processes.

Also provides ``multi_manuscript`` — the exact semantic of the shell
script (render pairing indices from train.csv) — as a Python entry point.

The port's own copy of ``playaid_core_tpu/pipeline/multi.py``; its command
line is argparse (``python -m playaid_core_torch.pipeline.multi``).
"""

from __future__ import annotations

import argparse
import os
import traceback
from concurrent.futures import ThreadPoolExecutor, as_completed
from datetime import datetime

from playaid_core_torch import constants
from playaid_core_torch.pipeline.manuscript import Manuscript
from playaid_core_torch.timeline import load_ground_truth_pairings_from_file


def render_one(job):
    """job: dict of Manuscript kwargs.  Returns (output_path, error|None)."""
    out = job.get("output_video_path")
    try:
        Manuscript(**job).render()
        return out, None
    except Exception as e:  # surface per-job failures without killing the batch
        return out, f"{e}\n{traceback.format_exc()}"


def run_batch(jobs, workers=None):
    """Render a batch of manuscript jobs concurrently.

    jobs: list of Manuscript kwarg dicts.  Returns list of
    (output_path, error) in completion order.
    """
    workers = workers or max(min(os.cpu_count() or 1, len(jobs)), 1)
    results = []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(render_one, job) for job in jobs]
        for fut in as_completed(futures):
            results.append(fut.result())
    return results


def jobs_from_pairings(indices, pairings_file=None, output_dir=None, **common_args):
    """Build Manuscript jobs from train.csv row indices
    (reference: multi_manuscript.sh + manuscript.py:346-361)."""
    pairings = load_ground_truth_pairings_from_file(
        pairings_file or constants.GROUND_TRUTH_TRAIN
    )
    date_time_str = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    jobs = []
    for index in indices:
        dir_name, video_name, log_name, log_offset = pairings[index]
        stem = os.path.splitext(video_name)[0]
        jobs.append(
            dict(
                input_video_path=os.path.join(constants.GROUND_TRUTH_DIR, dir_name, video_name),
                ground_truth_path=os.path.join(constants.GROUND_TRUTH_DIR, dir_name, log_name),
                log_offset=log_offset,
                # Row index + video stem keep outputs unique even when
                # several pairing rows share a directory.
                output_video_path=os.path.join(
                    output_dir or constants.EXPERIMENT_OUTPUT,
                    f"{dir_name}_{index}_{stem}_{date_time_str}.mp4",
                ),
                **common_args,
            )
        )
    return jobs


def multi_manuscript(indices="0,1,2,3,4,5,6", workers=None, skip_graphs=False,
                     skip_summaries=False):
    """Batch-render multiple VODs (replaces multi_manuscript.sh)."""
    idx = [int(v) for v in indices.split(",") if v != ""]
    jobs = jobs_from_pairings(
        idx, skip_graphs=skip_graphs, skip_summaries=skip_summaries, progress=False
    )
    for out, err in run_batch(jobs, workers=workers):
        status = "FAILED" if err else "ok"
        print(f"{status}: {out}")
        if err:
            print(err)
    print("🎉 COMPLETED 🎉")


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m playaid_core_torch.pipeline.multi",
                                description=multi_manuscript.__doc__)
    p.add_argument("--indices", "-i", default="0,1,2,3,4,5,6",
                   help="Comma-separated train.csv row indices (the shell script ran 0-6)")
    p.add_argument("--workers", "-w", default=None, type=int)
    p.add_argument("--skip-graphs", "-s", action="store_true")
    p.add_argument("--skip-summaries", "-c", action="store_true")
    multi_manuscript(**vars(p.parse_args(argv)))


if __name__ == "__main__":
    main()
